"""Op-level traces of the port's entry points: the one recorder every
invariant check shares.

Counterpart of the reference's ``jaxpr_utils`` and ``hlo_utils``. torch is
eager, so there is no graph to walk: to trace an entry point is to run it,
at small shapes, under ``record`` — a ``TorchDispatchMode`` that sees every
op below autograd and keeps one ``OpSite`` per op: its name, its inputs'
and outputs' shapes and dtypes, which outputs own **new storage** (a
storage none of the inputs has, decided by storage identity, so a view or
an in-place op is never a copy), whether it ran inside a loop trip, and
whether it read the watched tensor A.

* Loop trips: ``core.adaptive_padded._run_segment`` is a Python loop over
  ``_trip``. While a trace runs, both module attributes are swapped for
  wrappers (restored after it), so every site knows whether it ran inside a
  trip, and the ``PaddedState`` entering and leaving each segment is kept
  (``carries``: field → dtype). The engine's code is not changed.
* Kernels: the CUDA kernels launch through ``ctypes`` and are invisible to
  the dispatcher. A trace takes ``ops.LAUNCHES`` and ``ops.BODY_LAUNCHES``
  before and after, and ``count_a_consumers`` counts each launch as one
  consumer of A.
* Live bytes: every new storage is counted from the op that made it until
  the storage itself is freed (a weak-reference finalizer on the storage,
  so a view that outlives the tensor keeps its bytes counted), so
  ``peak_live_bytes`` is the largest sum of the run's own tensors alive at
  once: the CPU's counterpart of the card's peak above entry. Python's
  cyclic collector does not run on its own during a run: the recorder
  collects before the run and after every ``COLLECT_EVERY`` ops, so a
  storage held by a reference cycle is freed at the same op in every run
  and the peak does not depend on when the collector would have run (a
  run of millions of ops, the dry-run's recurrences, would otherwise hold
  their cycles' garbage, tens of GB, to its end).
* Provenance: the innermost frame under ``src/repro_torch`` outside this
  module, taken only for the sites a rule can report (new storage, a
  factorization, a collective, a contraction).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import weakref
from pathlib import Path
from typing import Callable, Iterable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

REDUCED_FLOAT = (torch.bfloat16, torch.float16)
FACTORIZATION_OPS = frozenset({
    "aten.linalg_cholesky_ex", "aten.cholesky", "aten.linalg_solve_triangular",
    "aten.triangular_solve", "aten.cholesky_solve", "aten.cholesky_inverse",
    "aten.linalg_inv_ex", "aten.linalg_lu_factor_ex", "aten.linalg_lu_solve",
    "aten._linalg_solve_ex", "aten.linalg_ldl_factor_ex", "aten.linalg_ldl_solve",
    "aten._linalg_eigh", "aten.linalg_eig", "aten.linalg_qr", "aten._linalg_svd",
})
CONTRACTION_OPS = frozenset({
    "aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.addbmm", "aten.mv",
    "aten.addmv", "aten.dot", "aten.vdot", "aten._scaled_mm",
})
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
COLLECT_EVERY = 1 << 16

PORT_DIR = Path(__file__).resolve().parents[2]             # src/repro_torch
ROOT_DIR = PORT_DIR.parents[1]                              # reports name paths from it
_PORT, _ROOT, _THIS = str(PORT_DIR), str(ROOT_DIR), str(Path(__file__).resolve())


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One op as it ran. ``op`` is ``str(func)`` (``aten.mm.default``),
    ``base`` the op without its overload (``aten.mm``); ``new`` marks, per
    output, whether it owns new storage."""

    op: str
    base: str
    in_shapes: tuple[tuple[int, ...], ...]
    in_dtypes: tuple[torch.dtype, ...]
    out_shapes: tuple[tuple[int, ...], ...]
    out_dtypes: tuple[torch.dtype, ...]
    new: tuple[bool, ...]
    in_trip: bool = False
    reads_a: bool = False
    provenance: str = ""

    @property
    def is_collective(self) -> bool:
        return self.base.split(".")[0] in COLLECTIVE_NAMESPACES

    def new_tensors(self) -> Iterator[tuple[tuple[int, ...], torch.dtype]]:
        for shape, dtype, is_new in zip(self.out_shapes, self.out_dtypes, self.new):
            if is_new:
                yield shape, dtype

    def in_bytes(self) -> int:
        return sum(_nbytes(s, t) for s, t in zip(self.in_shapes, self.in_dtypes))


@dataclasses.dataclass
class OpTrace:
    """What one run on ``device`` recorded: the sites in order, the kernel
    launches (``ops.LAUNCHES`` / ``ops.BODY_LAUNCHES`` deltas), the loop
    trips run, the ``PaddedState`` carries (label, field → dtype,
    provenance) and the run's result (dropped when a trace crosses a
    process boundary)."""

    sites: list[OpSite]
    launches: dict[str, int]
    body_launches: dict[str, int]
    device: str = "cpu"
    trips: int = 0
    peak_live_bytes: int = 0
    carries: list[tuple[str, dict[str, torch.dtype], str]] = dataclasses.field(
        default_factory=list)
    result: object = None

    def without_result(self) -> "OpTrace":
        return dataclasses.replace(self, result=None)


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = dtype.itemsize
    for s in shape:
        n *= int(s)
    return n


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def repo_relative(path: str | Path) -> Path:
    """``path`` from the repository's root where it lies inside it."""
    path = Path(path).resolve()
    return path.relative_to(ROOT_DIR) if path.is_relative_to(ROOT_DIR) else path


def provenance(label: str = "", depth: int = 1) -> str:
    """``src/repro_torch/<module>.py:<line>`` of the innermost frame of the
    port outside this module, from ``depth`` frames above this call, with
    ``label`` (the op) beside it."""
    f = sys._getframe(depth)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PORT) and fn != _THIS:
            where = f"{fn[len(_ROOT) + 1:]}:{f.f_lineno}"
            return f"{where} ({label})" if label else where
        f = f.f_back
    return f"<outside src/repro_torch> ({label})" if label else "<outside src/repro_torch>"


def _base(func) -> str:
    return f"{func.namespace}.{func._opname}"


class _Recorder(TorchDispatchMode):
    def __init__(self, watch: Iterable[torch.Tensor] = (), sink=None):
        super().__init__()
        self.sites: list[OpSite] = []
        self.sink = sink
        self.watch = {_storage_key(t) for t in watch}
        self.trip_depth = 0
        self.trips = 0
        self.carries: list = []
        self.live: dict[int, int] = {}       # storage key → bytes, while alive
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.n_ops = 0

    def _release(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def _track(self, t: torch.Tensor, key: int) -> None:
        if key not in self.live:
            self.live[key] = nbytes = t.untyped_storage().nbytes()
            self.live_bytes += nbytes
            weakref.finalize(t.untyped_storage(), self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.n_ops += 1
        if self.n_ops % COLLECT_EVERY == 0:
            gc.collect()
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        in_keys = {_storage_key(t) for t in ins}
        new = tuple(_storage_key(t) not in in_keys for t in outs)
        for t, is_new in zip(outs, new):
            if is_new:
                self._track(t, _storage_key(t))
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        base = _base(func)
        reads_a = bool(self.watch) and not func.is_view and bool(in_keys & self.watch)
        reportable = self.sink is None and (
            any(new) or base in FACTORIZATION_OPS or base in CONTRACTION_OPS
            or base.split(".")[0] in COLLECTIVE_NAMESPACES)
        site = OpSite(
            op=str(func), base=base,
            in_shapes=tuple(tuple(t.shape) for t in ins),
            in_dtypes=tuple(t.dtype for t in ins),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_dtypes=tuple(t.dtype for t in outs),
            new=new, in_trip=self.trip_depth > 0, reads_a=reads_a,
            provenance=provenance(str(func)) if reportable else "")
        if self.sink is None or self.sink(site):
            self.sites.append(site)
        return out


def _state_dtypes(st) -> dict[str, torch.dtype]:
    return {k: v.dtype for k, v in st._asdict().items() if torch.is_tensor(v)}


@contextlib.contextmanager
def _marked_trips(rec: _Recorder):
    """Swap the engine's ``_trip`` and ``_run_segment`` for wrappers that
    mark the loop's trips and keep each segment's state carries."""
    from repro_torch.core import adaptive_padded as ap

    trip, run_segment = ap._trip, ap._run_segment

    def marked_trip(*args, **kwargs):
        rec.trips += 1
        rec.trip_depth += 1
        try:
            return trip(*args, **kwargs)
        finally:
            rec.trip_depth -= 1

    def marked_segment(q, pre, st, *args, **kwargs):
        where = provenance("_run_segment")
        rec.carries.append(("segment in", _state_dtypes(st), where))
        out = run_segment(q, pre, st, *args, **kwargs)
        rec.carries.append(("segment out", _state_dtypes(out), where))
        return out

    ap._trip, ap._run_segment = marked_trip, marked_segment
    try:
        yield
    finally:
        ap._trip, ap._run_segment = trip, run_segment


def record(fn: Callable[[], object], watch: Iterable[torch.Tensor] = (),
           device="cpu", *, sink: Callable[[OpSite], bool] | None = None) -> OpTrace:
    """Run ``fn()`` (on ``device``) under the recorder and return its
    ``OpTrace``. ``watch`` holds A (or its shards): a non-view op that reads
    its storage is a consumer of A (``count_a_consumers``). ``sink`` is
    handed every site as it is made, and the trace keeps only the sites it
    returns True for, with no provenance: a run of millions of ops (the
    model dry-run's recurrences) keeps its tallies, not its sites."""
    from repro_torch.kernels import ops

    launches0, bodies0 = dict(ops.LAUNCHES), dict(ops.BODY_LAUNCHES)
    rec = _Recorder(watch, sink)
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with _marked_trips(rec), rec:
            result = fn()
    finally:
        if collecting:
            gc.enable()
    return OpTrace(
        sites=rec.sites,
        launches={k: v - launches0[k] for k, v in ops.LAUNCHES.items()},
        body_launches={k: v - bodies0[k] for k, v in ops.BODY_LAUNCHES.items()},
        device=str(torch.device(device)), trips=rec.trips,
        peak_live_bytes=rec.peak_live_bytes, carries=rec.carries, result=result)


# ---------------------------------------------------------------------------
# queries, with the reference's names where they fit
# ---------------------------------------------------------------------------

def iter_sites(trace: OpTrace, pred: Callable[[OpSite], bool] | None = None
               ) -> Iterator[OpSite]:
    for s in trace.sites:
        if pred is None or pred(s):
            yield s


def collect_sites(trace: OpTrace, bases: str | Iterable[str]) -> list[OpSite]:
    """Every site whose op (without overload: ``aten.mm``) is in ``bases``."""
    names = {bases} if isinstance(bases, str) else set(bases)
    return [s for s in trace.sites if s.base in names]


def count_op(trace: OpTrace, bases: str | Iterable[str]) -> int:
    return len(collect_sites(trace, bases))


def find_new_tensors(trace: OpTrace,
                     pred: Callable[[tuple[int, ...], torch.dtype], bool]) -> list[OpSite]:
    """Sites with at least one new-storage output whose (shape, dtype)
    satisfies ``pred`` — the one-touch and precision rules' workhorse."""
    return [s for s in trace.sites if any(pred(shape, dt) for shape, dt in s.new_tensors())]


def max_new_tensor_bytes(trace: OpTrace) -> tuple[int, tuple[int, ...], OpSite | None]:
    """(bytes, shape, site) of the largest new tensor the run made."""
    best, shape, where = 0, (), None
    for s in trace.sites:
        for shp, dt in s.new_tensors():
            nb = _nbytes(shp, dt)
            if nb > best:
                best, shape, where = nb, shp, s
    return best, shape, where


def count_a_consumers(trace: OpTrace) -> int:
    """Non-view ops that read A's storage (the ``watch`` of ``record``),
    plus every kernel launch, each of which streams A once. The count is
    calibration-relative: the one-touch rule compares a λ-grid run against
    its one-point run, never against an absolute number."""
    return (sum(s.reads_a for s in trace.sites)
            + sum(trace.body_launches.values()))


def op_sequence(trace: OpTrace) -> list[tuple]:
    """(op, output shapes, output dtypes) in order: what two runs must
    share to be the same computation (the fp32-identity check)."""
    return [(s.op, s.out_shapes, s.out_dtypes) for s in trace.sites]
