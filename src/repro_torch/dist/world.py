"""The life cycle of a `torch.distributed` world: the process groups
that JAX keeps implicit behind its device list.

Every rank runs the same program on its own device (SPMD).  A world is
started by `torchrun` (which sets RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE and the rendezvous address) or by `spawn`, which
starts the ranks itself:

    init_world()                       # under torchrun
    init_world(rank=r, world_size=n, backend="gloo", device="cpu",
               store=dist.FileStore(path, n))
    results = spawn(fn, 4, backend="gloo", device="cpu")

The backend follows one rule: NCCL only when every rank owns a distinct
card; gloo on the CPU and for ranks that share a card (NCCL refuses two
ranks on one GPU).  Asking for NCCL on ranks that share a card raises
ValueError before any process group is made.  Every group carries a
timeout (default 120 s), so a rank that stops making calls fails the run
instead of hanging it.

A dry run needs no ranks at all: `fake_world(size, rank)` makes this
process rank `rank` of a world of `size` under torch's fake backend,
whose collectives move nothing, on the meta device (every rank's device
is `meta`), so that one rank's step of a mesh of hundreds of cards can
be counted (`launch.dryrun`).  Cards sit CARDS_PER_NODE to a node,
ranks 8n .. 8n + 7 on node n.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import torch

DEFAULT_TIMEOUT_S = 120.0
# cards a node: an HGX H100 board's eight, all to all over NVLink; ranks
# 8n .. 8n + 7 lie on node n
CARDS_PER_NODE = 8

_WORLD = None


@dataclasses.dataclass
class World:
    """This rank's view of a live process group."""
    rank: int
    size: int
    local_rank: int
    backend: str
    device: torch.device          # this rank's device
    devices: tuple                # every rank's device, in rank order
    timeout_s: float
    # the process groups of meshes over this world, built once a layout
    groups: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def tag(self) -> str:
        return f"{self.size}x{self.device.type}/{self.backend}"


def current_world() -> World | None:
    """The world `init_world` started in this process, or None."""
    return _WORLD


def device_for_rank(local_rank: int, device=None) -> torch.device:
    """cuda:(local_rank % device_count), or the CPU when `device` asks
    for it."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device for this rank; pass "
                           "device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank % n)


def choose_backend(backend, device: torch.device,
                   local_world_size: int) -> str:
    """The backend for ranks on `device`: NCCL only when every rank of
    the host owns a distinct card, gloo otherwise.  An explicit "nccl"
    for ranks that share a card, or for CPU ranks, raises ValueError."""
    shared = device.type == "cuda" and \
        local_world_size > torch.cuda.device_count()
    if backend is None:
        return "nccl" if device.type == "cuda" and not shared else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend nccl needs CUDA ranks; use gloo on the "
                         "CPU")
    if backend == "nccl" and shared:
        raise ValueError(
            f"backend nccl for {local_world_size} ranks on "
            f"{torch.cuda.device_count()} card(s): NCCL refuses ranks that "
            "share a card; use gloo, or one rank a card")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: use gloo or nccl")
    return backend


def _env_int(name: str, given):
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"{name} is not set: launch under torchrun, or "
                         f"pass it to init_world")
    return int(os.environ[name])


def init_world(*, rank=None, world_size=None, local_rank=None,
               local_world_size=None, backend=None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S, store=None) -> World:
    """Start this rank's process group and return its `World`.

    Unset arguments come from torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
    LOCAL_WORLD_SIZE (LOCAL_RANK defaults to RANK, LOCAL_WORLD_SIZE to
    WORLD_SIZE: one host).  With no `store` the rendezvous is torchrun's
    (`env://`).  The device is `device_for_rank(local_rank, device)`,
    made current for CUDA; the backend follows `choose_backend`."""
    global _WORLD
    import torch.distributed as dist
    if _WORLD is not None or dist.is_initialized():
        raise RuntimeError("a process group is already initialised in "
                           "this process")
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) \
        if local_rank is None else int(local_rank)
    local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size)) \
        if local_world_size is None else int(local_world_size)
    dev = device_for_rank(local_rank, device)
    backend = choose_backend(backend, dev, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    kw = {"store": store} if store is not None else {"init_method": "env://"}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=timeout, **kw)
    devices = [None] * world_size
    dist.all_gather_object(devices, str(dev))
    _WORLD = World(rank=rank, size=world_size, local_rank=local_rank,
                   backend=backend, device=dev,
                   devices=tuple(torch.device(d) for d in devices),
                   timeout_s=float(timeout_s))
    return _WORLD


def shutdown() -> None:
    """Destroy the process group `init_world` started (a no-op without
    one)."""
    global _WORLD
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """For the duration, this process is rank `rank` of a world of `size`
    ranks under torch's fake backend: the collectives dispatch as they
    would (a `TorchDispatchMode` sees them, with their groups) but move
    nothing, and every rank's device is `meta`.  Yields the `World`; on
    exit, raised or not, the process group is destroyed and no world is
    left behind."""
    global _WORLD
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if _WORLD is not None or dist.is_initialized():
        raise RuntimeError("a process group is already initialised in "
                           "this process")
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} of a world of {size}")
    # init_process_group wraps sys.excepthook to prefix "[rank N]" and
    # never unwraps it: a process of many fake worlds would nest them
    hook = sys.excepthook
    try:
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=size)
        meta = torch.device("meta")
        world = World(rank=rank, size=size, local_rank=rank % CARDS_PER_NODE,
                      backend="fake", device=meta, devices=(meta,) * size,
                      timeout_s=DEFAULT_TIMEOUT_S)
        _WORLD = world
        yield world
    finally:
        if _WORLD is not None:
            _WORLD.groups.clear()
        shutdown()
        sys.excepthook = hook


# ---------------------------------------------------------------------------
# spawn: a world of child processes, for tests and the smoke script
# ---------------------------------------------------------------------------
def _rank_main(fn, args, rank, world, backend, device, timeout_s,
               store_path, out_dir) -> None:
    import torch.distributed as dist
    out = os.path.join(out_dir, f"rank{rank}")
    if torch.device(device).type == "cpu":       # the ranks share the host
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        init_world(rank=rank, world_size=world, local_rank=rank,
                   local_world_size=world, backend=backend, device=device,
                   timeout_s=timeout_s,
                   store=dist.FileStore(store_path, world))
        result = fn(*args)
        torch.save(result, out + ".pt.tmp")
        os.replace(out + ".pt.tmp", out + ".pt")
    except BaseException as e:                   # noqa: BLE001 (re-raised)
        tb = traceback.format_exc()
        try:
            blob = pickle.dumps(e)
        except Exception:                        # noqa: BLE001
            blob = pickle.dumps(RuntimeError(f"{type(e).__name__}: {e}"))
        with open(out + ".err.tmp", "wb") as f:
            pickle.dump((blob, tb), f)
        os.replace(out + ".err.tmp", out + ".err")
    finally:
        shutdown()


def spawn(fn, world: int, *, backend: str = "gloo", device="cpu",
          timeout_s: float = DEFAULT_TIMEOUT_S, deadline_s=None,
          args: tuple = ()) -> list:
    """Run `fn(*args)` on every rank of a new world of `world` child
    processes and return their results in rank order.

    The ranks meet through a `FileStore` in a temporary directory (no TCP
    port, so concurrent worlds cannot collide) and start with the
    `spawn` method (CUDA cannot fork); CPU ranks split the host's cores
    between them.  `fn` must be importable by name
    from a module the children can import; its result travels back
    through `torch.save`, so tensors in it should be on the CPU.  The
    parent waits at most `deadline_s` (default `timeout_s` + 30 s), then
    kills the children; the first exception a rank raises (the first
    written) is re-raised here, with that rank's traceback as a note,
    and the others killed."""
    import multiprocessing as mp
    choose_backend(backend, device_for_rank(0, device), world)
    deadline = time.monotonic() + (timeout_s + 30.0 if deadline_s is None
                                   else deadline_s)
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, world, backend, device,
                               timeout_s, os.path.join(tmp, "store"), tmp))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        pending = set(range(world))
        while pending:
            # the first error written: the others may follow from it (a
            # rank's peers fail their collectives once it has exited)
            errs = sorted((os.stat(e).st_mtime_ns, r, e) for r in range(world)
                          for e in [os.path.join(tmp, f"rank{r}.err")]
                          if os.path.exists(e))
            if errs:
                _, r, path = errs[0]
                with open(path, "rb") as f:
                    blob, tb = pickle.load(f)
                err = pickle.loads(blob)
                err.add_note(f"raised on rank {r} of {world}:\n{tb}")
                raise err
            for r in sorted(pending):
                # read before its result: a dead rank has written it
                alive = procs[r].is_alive()
                if os.path.exists(os.path.join(tmp, f"rank{r}.pt")):
                    pending.discard(r)
                elif not alive and not os.path.exists(
                        os.path.join(tmp, f"rank{r}.err")):
                    raise RuntimeError(
                        f"rank {r} of {world} exited with code "
                        f"{procs[r].exitcode} and no result")
            if pending and time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(pending)} of {world} gave no result "
                    "before the deadline; the world was killed")
            if pending:
                time.sleep(0.02)
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
