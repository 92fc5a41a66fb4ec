"""Meshes over ``torch.distributed`` ranks, and a launcher that runs a rank
program in K processes.

Port of ``repro.launch.mesh``. The reference builds JAX meshes over the
devices of one controller; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with named dims ``("data", "model")`` (``core.distributed``
reads ``data_axes``, ``n_data_shards`` and this rank's ``data_index``).
Meshes are made by functions, never at import; ``make_production_mesh``
gives the reference's 16×16 and 2×16×16 meshes over a fake process group,
for the dry-run (``launch.dryrun_solver``).

``run_ranks(job, world, payload)`` starts ``world`` processes of
``python -m repro_torch.launch.mesh``, each of which forms the process
group from a ``file://`` store in a fresh temporary directory (no TCP port,
so concurrent launchers never collide), builds a one-dimensional
``("data",)`` mesh, calls ``job(mesh, payload)`` and saves its result; the
launcher returns the results in rank order, and on any failure or timeout
kills every rank and raises with the failing rank's traceback. A rank that
ends with ``RankExit(EXIT_PREEMPTED)`` (75: preempted, its checkpoint
committed) has not failed, and its result carries its ``exit_code``.
``job`` is a
``"module:function"`` name, imported in each child: keep rank programs in
modules that import only the port (``launch.sharded``). ``backend`` is
``"gloo"`` (the CPU, or K ranks that share one card: NCCL does not put two
ranks on one GPU) or ``"nccl"``; ``device`` is where each rank computes (default ``cuda``,
which means ``cuda:(rank mod the card count)`` and raises without a card;
``"cpu"`` only when asked for). A rank program reads its device from the
mesh (``rank_device``), so the device is given once, to ``run_ranks``.
Each rank runs its torch ops on one thread.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.core.distributed import data_axes, data_index, n_data_shards  # noqa: F401
from repro_torch.device import resolve_device


def _init_mesh(device_type: str, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def rank_device(mesh) -> torch.device:
    """This rank's device: the mesh's device type, on a card the rank's
    current one (``run_ranks`` sets it)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over a fake process group (torch's
    testing ``FakeStore``, backend ``"fake"``): no rank exists and a
    collective moves no byte, which is what a dry-run traces (under
    ``FakeTensorMode``). This process is rank 0. The group is made on entry
    and destroyed on exit; a process that already has a process group is
    refused, so a real group is never touched."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a fake mesh needs a process without a process group; "
                           "this one has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield _init_mesh("cpu", tuple(shape), tuple(names))
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes, over a fake group (``fake_mesh``, a
    context manager): 16×16 ``("data", "model")`` (256 chips) or 2×16×16
    ``("pod", "data", "model")`` (512)."""
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return fake_mesh((16, 16), ("data", "model"))


def make_host_mesh(model: int | None = None, *, device_type: str | None = None):
    """A (data, model) mesh over every rank of the default process group:
    model 2 or 4 when the rank count allows (as the reference picks it),
    else 1. ``device_type`` None means ``cuda``."""
    device_type = resolve_device(device_type).type
    n = dist.get_world_size()
    if model is None:
        model = 1
        for cand in (2, 4):
            if n % cand == 0 and n >= cand * 2:
                model = cand
    return _init_mesh(device_type, (n // model, model), ("data", "model"))


def make_elastic_mesh(n_devices: int, *, device_type: str | None = None):
    """The (data, model) mesh ``ft.resilience.plan_mesh_shape`` plans for
    ``n_devices`` live ranks (the default group's size); ``device_type``
    None means ``cuda``."""
    from repro_torch.ft.resilience import plan_mesh_shape

    device_type = resolve_device(device_type).type
    if n_devices != dist.get_world_size():
        raise ValueError(f"an elastic mesh of {n_devices} ranks needs a process "
                         f"group of that size, not {dist.get_world_size()}")
    return _init_mesh(device_type, plan_mesh_shape(n_devices), ("data", "model"))


EXIT_PREEMPTED = 75          # EX_TEMPFAIL: preempted after a commit; restart to resume
_CLEAN_EXITS = (None, 0, EXIT_PREEMPTED)


def _resolve(job: str):
    module, _, name = job.partition(":")
    return getattr(importlib.import_module(module), name)


def _src_dir() -> str:
    import repro_torch

    return str(Path(repro_torch.__file__).resolve().parents[1])


class RankExit(Exception):
    """Raised by a rank program to end its rank with exit code ``code`` and
    still hand ``result`` (a dict) back, with ``exit_code`` = ``code`` in it:
    ``EXIT_PREEMPTED`` after a preempted solve committed its checkpoint."""

    def __init__(self, code: int, result: dict | None = None):
        super().__init__(f"rank exits {code}")
        self.code = code
        self.result = {**(result or {}), "exit_code": code}


def run_ranks(job: str, world: int, payload=None, *, backend: str = "gloo",
              device=None, timeout: float = 600.0, signal_rank=None) -> list:
    """Run ``job(mesh, payload)`` on ``world`` ranks (module docstring);
    returns the rank results in rank order. ``payload`` and the results
    cross the process boundary through ``torch.save``.

    A rank that raises ``RankExit(EXIT_PREEMPTED, result)`` exits 75, which
    is not a failure: its result holds ``exit_code`` 75, so the caller sees
    which ranks were preempted. ``signal_rank=(rank,
    marker, seconds)`` sends SIGTERM to that rank ``seconds`` after the line
    ``marker`` appears in its output (a scheduler preempting one host)."""
    device = resolve_device(device).type
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_ranks_"))
    procs = []
    try:
        torch.save(payload, tmp / "payload.pt")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_src_dir(), os.environ.get("PYTHONPATH")) if p)
        for rank in range(world):
            with open(tmp / f"rank{rank}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.mesh", "--job", job,
                     "--rank", str(rank), "--world", str(world), "--dir", str(tmp),
                     "--backend", backend, "--device", device],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        fire_at = None
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in _CLEAN_EXITS]
            if failed or time.monotonic() > deadline:
                break
            if signal_rank is not None:
                rank, marker, seconds = signal_rank
                if fire_at is None and marker in (tmp / f"rank{rank}.log").read_text():
                    fire_at = time.monotonic() + seconds
                if fire_at is not None and time.monotonic() >= fire_at:
                    if procs[rank].poll() is None:
                        procs[rank].send_signal(signal.SIGTERM)
                    signal_rank = None
            time.sleep(0.05)
        codes = [p.poll() for p in procs]
        if any(c not in (0, EXIT_PREEMPTED) for c in codes):
            bad = next((r for r, c in enumerate(codes) if c not in _CLEAN_EXITS), 0)
            log = (tmp / f"rank{bad}.log").read_text()[-4000:]
            what = "timed out" if all(c in _CLEAN_EXITS for c in codes) else "failed"
            raise RuntimeError(f"run_ranks({job!r}, {world}) {what}; exit codes {codes}; "
                               f"rank {bad}'s output:\n{log}")
        results = [torch.load(tmp / f"result{r}.pt", weights_only=False) for r in range(world)]
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of launch.mesh.run_ranks")
    for flag in ("--job", "--dir", "--backend", "--device"):
        ap.add_argument(flag, required=True)
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    tmp = Path(args.dir)
    try:
        if args.device == "cuda":
            torch.cuda.set_device(args.rank % torch.cuda.device_count())
        dist.init_process_group(args.backend, init_method=f"file://{tmp / 'store'}",
                                rank=args.rank, world_size=args.world)
        mesh = _init_mesh(args.device, (args.world,), ("data",))
        payload = torch.load(tmp / "payload.pt", weights_only=False)
        # run as ``-m``, this module is __main__: the rank program raises the
        # importable module's RankExit
        from repro_torch.launch.mesh import RankExit as rank_exit

        code = 0
        try:
            result = _resolve(args.job)(mesh, payload)
        except rank_exit as e:
            code, result = e.code, e.result
        torch.save(result, tmp / f"result{args.rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        return 1
    return code


if __name__ == "__main__":
    sys.exit(_rank_main())
