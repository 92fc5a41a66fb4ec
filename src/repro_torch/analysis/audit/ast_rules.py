"""Source lints that need no trace: seed hygiene and status-lattice
handling, over every module of ``src/repro_torch``.

Port of ``repro.analysis.audit.ast_rules``. The port's per-problem key is
a uint32 seed folded with ``fold_seeds`` (``core.level_grams``): the
service folds request ids (padded slots take the reserved top of the
range), retries fold the attempt, shards the shard index, the Newton
driver the outer step. The statically checkable residue of that contract:

* a module must not build a root generator from the same literal twice
  (``torch.manual_seed(<lit>)``, ``Generator().manual_seed(<lit>)``): two
  identical roots in one module are how two "independent" draws end up
  correlated;
* one function must not call ``fold_seeds(seed, <lit>)`` twice with the
  same constant tag: the reuse the slot-seed scheme exists to prevent.
  ``hash_stream`` is not linted: ``ops.srht_sample`` reads stream 1 in two
  exclusive branches, and the reference lints only ``fold_in``.

Status lattice: a module that reads engine stats' ``status`` must name the
lattice (``SolveStatus``, ``ENGINE_FAILURES``, ``status_name`` or
``CONVERGED_STATUSES``, ``core/status.py``): a compare against a bare
integer breaks silently when the lattice gains a member.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .op_trace import PORT_DIR, repo_relative
from .rules import Violation

_LATTICE_NAMES = ("SolveStatus", "ENGINE_FAILURES", "status_name", "CONVERGED_STATUSES")


def _is_call_named(node: ast.Call, name: str) -> bool:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id == name
    if isinstance(fn, ast.Attribute):
        return fn.attr == name
    return False


def _int_literal(node) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    return None


def lint_module_source(source: str, module_name: str, path: str = "<string>",
                       first_line: int = 1) -> list[Violation]:
    """Every seed-hygiene and status-lattice finding of one module's source;
    ``first_line`` is the line of ``path`` on which ``source`` starts."""
    out: list[Violation] = []
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation("key_hygiene", module_name, f"unparsable source: {e}",
                          f"{path}:{first_line + (e.lineno or 1) - 1}")]

    def where(node) -> str:
        return f"{path}:{first_line + node.lineno - 1}"

    # -- root seed literal reuse (module scope) -----------------------------
    seen_roots: dict[int, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_call_named(node, "manual_seed") and node.args:
            lit = _int_literal(node.args[0])
            if lit is None:
                continue
            if lit in seen_roots:
                out.append(Violation(
                    "key_hygiene", module_name,
                    f"manual_seed({lit}) built twice (first at line {seen_roots[lit]}): "
                    f"duplicate root seeds correlate draws", where(node)))
            else:
                seen_roots[lit] = first_line + node.lineno - 1

    # -- fold_seeds constant-tag reuse (function scope) ---------------------
    for fn_node in ast.walk(tree):
        if not isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        seen_tags: dict[int, int] = {}
        for node in ast.walk(fn_node):
            if (isinstance(node, ast.Call) and _is_call_named(node, "fold_seeds")
                    and len(node.args) >= 2):
                lit = _int_literal(node.args[1])
                if lit is None:
                    continue
                if lit in seen_tags:
                    fname = getattr(fn_node, "name", "<lambda>")
                    out.append(Violation(
                        "key_hygiene", module_name,
                        f"fold_seeds(…, {lit}) called twice in `{fname}` (first at line "
                        f"{seen_tags[lit]}): a reused tag yields identical derived seeds",
                        where(node)))
                else:
                    seen_tags[lit] = first_line + node.lineno - 1

    # -- status-lattice handling --------------------------------------------
    reads = [node for node in ast.walk(tree)
             if isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant)
             and node.slice.value == "status" and isinstance(node.value, ast.Name)
             and "stats" in node.value.id]
    if reads and not any(n in source for n in _LATTICE_NAMES):
        out.append(Violation(
            "status_lattice", module_name,
            "reads engine stats['status'] without naming the status lattice "
            "(SolveStatus / ENGINE_FAILURES / status_name)", where(reads[0])))
    return out


def lint_tree(root: str | Path = PORT_DIR) -> list[Violation]:
    """Lint every module under ``root`` (default: this package), each
    finding placed at ``src/repro_torch/<module>.py:<line>``; the audit's
    own fixtures are skipped, since they exist to violate."""
    root = Path(root).resolve()
    out: list[Violation] = []
    for f in sorted(root.rglob("*.py")):
        if f.name == "fixtures.py" and "audit" in f.parts:
            continue
        module = f.relative_to(root.parent).with_suffix("")
        out.extend(lint_module_source(f.read_text(), ".".join(module.parts),
                                      str(repo_relative(f))))
    return out
