"""The port's trip-weighted op-level cost model (`repro_torch.dist.
op_analysis`), the counterpart of `repro.dist.hlo_analysis`.

The flop rules are held against the reference's `_dot_flops` and
`_conv_flops` on HLO lines in the typed-operand form those functions
parse; the torch twin of the reference test's nested scan (10 x 5
products of 128x256 by 256x256) counts exactly 838,860,800 flops, in
full and trip-weighted modes.  On reduced cells of every arch (d_model
64; a one-block pattern at four cycles, a longer one at one cycle; B 2,
S 64, with the loops' chunks cut so that every routed loop runs at
least four trips and AdamW's last chunk is ragged), the trip-weighted
count of a step on meta tensors equals the full count of the same step
on CPU tensors in flops, bytes and the tally by op, and the flops of
its dot ops equal `FlopCounterMode`'s; in float the two peaks of live
bytes are equal too (the train cells are in
`test_torch_op_analysis_train.py`).
"""
import numpy as np
import pytest
import torch

from repro.dist import hlo_analysis as H
from repro_torch.configs.base import ARCH_IDS, ShapeSpec, get_config
from repro_torch.dist import op_analysis as oa
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import reduced
from repro_torch.models import attention, scan_utils, transformer
from repro_torch.optim import adam
from repro_torch.tree import tree_map

META = torch.device("meta")
NESTED_FLOPS = 50 * 2 * 128 * 256 * 256          # 838,860,800


def _instr(op: str, line: str) -> H.Instr:
    return H.Instr("x", op, line.split(" ")[0], line.split(" ", 1)[1])


# ---------------------------------------------------------------------------
# flop rules against the reference's parsers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch,m,k,n", [((), 8, 16, 32), ((), 128, 256, 256),
                                         ((4,), 3, 5, 7), ((2,), 64, 1, 9)])
def test_dot_rule_equals_reference(batch, m, k, n):
    dims = ",".join(map(str, batch + (m, k)))
    rdims = ",".join(map(str, batch + (k, n)))
    odims = ",".join(map(str, batch + (m, n)))
    bd = ",".join(map(str, range(len(batch))))
    line = (f"f32[{odims}]{{0}} f32[{dims}]{{1,0}} %a, f32[{rdims}]{{1,0}} "
            f"%b), lhs_batch_dims={{{bd}}}, lhs_contracting_dims="
            f"{{{len(batch) + 1}}}, rhs_contracting_dims={{{len(batch)}}}")
    ref = H._dot_flops(_instr("dot", line))
    a = torch.empty(batch + (m, k), device=META)
    b = torch.empty(batch + (k, n), device=META)
    with oa.OpCounter() as c:
        torch.matmul(a, b)
    assert oa.dot_flops(batch + (m, k), batch + (m, n)) == ref
    assert c.cost.flops == ref > 0


@pytest.mark.parametrize("n,ci,co,hw,k,stride,groups", [
    (1, 3, 8, 16, 3, 1, 1), (2, 4, 6, 9, 5, 2, 1), (1, 8, 8, 7, 3, 1, 4),
    (3, 1, 2, 28, 9, 1, 1)])
def test_conv_rule_equals_reference(n, ci, co, hw, k, stride, groups):
    x = torch.empty((n, ci, hw, hw), device=META)
    w = torch.empty((co, ci // groups, k, k), device=META)
    with oa.OpCounter() as c:
        y = torch.nn.functional.conv2d(x, w, stride=stride, groups=groups)
    o = y.shape
    # the reference's NHWC / HWIO line of the same convolution
    line = (f"f32[{o[0]},{o[2]},{o[3]},{o[1]}]{{3,2,1,0}} "
            f"f32[{n},{hw},{hw},{ci}]{{3,2,1,0}} %x, "
            f"f32[{k},{k},{ci // groups},{co}]{{3,2,1,0}} %w), "
            f"window={{size={k}x{k} stride={stride}x{stride}}}, "
            f"dim_labels=b01f_01io->b01f, feature_group_count={groups}")
    ref = H._conv_flops(_instr("convolution", line))
    assert c.cost.flops == ref > 0


# ---------------------------------------------------------------------------
# loops, bytes, memory
# ---------------------------------------------------------------------------
def _nested(x, ws):
    def outer(i, c):
        def inner(_, h):
            return torch.tanh(h @ ws[i]), None
        return oa.trip_scan(inner, 5, c)[0], None
    return oa.trip_scan(outer, ws.shape[0], x)[0]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_nested_scan_twin_counts_the_reference_tests_flops(device):
    """Full on CPU tensors, trip-weighted on meta ones (outer 0, 1 x 8,
    9; inner 0, 1 x 3, 4 at each)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(128, 256)).astype(np.float32))
    ws = torch.from_numpy(rng.normal(size=(10, 256, 256)).astype(np.float32))
    if device == "meta":
        x, ws = x.to(META), ws.to(META)
    res = oa.analyze_ops(_nested, x, ws)
    assert res.cost.flops == NESTED_FLOPS
    assert res.cost.ops["aten.mm.default"] == 50
    assert res.cost.ops["aten.tanh.default"] == 50
    assert res.cost.n_loops == 11
    assert tuple(res.out.shape) == (128, 256)


def test_trip_scan_outputs_keep_full_shapes_and_a_ragged_last_trip():
    x = torch.arange(103, dtype=torch.float32)

    def run(x):
        def part(i, acc):
            blk = x[i * 10:(i + 1) * 10]
            return acc + blk.sum(), blk * 2
        acc, ys = oa.trip_scan(part, 11, torch.zeros(()))
        return acc, torch.cat(ys)

    full = oa.analyze_ops(run, x)
    weighted = oa.analyze_ops(run, x.to(META))
    assert torch.equal(full.out[1], x * 2) and full.out[0] == x.sum()
    assert weighted.out[1].shape == (103,)
    assert not full.cost.ops == {}
    assert (weighted.cost.ops, weighted.cost.hbm_bytes) == \
        (full.cost.ops, full.cost.hbm_bytes)


def test_trip_scan_outside_a_count_is_a_plain_loop():
    seen = []
    carry, ys = oa.trip_scan(lambda i, c: (c + i, seen.append(i) or i), 6, 0)
    assert (carry, ys, seen) == (15, list(range(6)), list(range(6)))


def test_views_are_free_and_an_in_place_op_counts_its_operand_once():
    a = torch.empty((64, 32), device=META)
    b = torch.empty((64, 32), device=META)
    with oa.OpCounter() as c:
        a.t()[::2].unsqueeze(0).expand(3, -1, -1)
        a.view(32, 64)[1:].detach()
    assert (c.cost.hbm_bytes, c.cost.ops) == (0, {})
    with oa.OpCounter() as c:
        a.add_(b)
    assert c.cost.hbm_bytes == 2 * 64 * 32 * 4
    with oa.OpCounter() as c:
        a + b
    assert c.cost.hbm_bytes == 3 * 64 * 32 * 4
    with oa.OpCounter() as c:
        a[:16].copy_(b[:16])
    assert c.cost.hbm_bytes == 2 * 16 * 32 * 4
    assert c.cost.ops == {"aten.copy_.default": 1}


def test_live_bytes_peak_of_a_hand_built_program():
    """A storage counted once across its views and freed with its last
    reference; a tensor autograd saves stays live; an allocation counts
    though it moves no bytes."""
    MB, N = 1 << 20, (1 << 20) // 4
    x = torch.empty(N, device=META, requires_grad=True)
    live = []

    def prog(x):
        mem = oa.active.mem
        a = torch.ones(N, device=META)
        v = a[: N // 2]
        live.append(mem.live)                    # 1 MB: a, v a view of it
        del a
        live.append(mem.live)                    # v keeps a's storage
        del v
        live.append(mem.live)                    # 0
        b = torch.ones(N, device=META)
        c = (b * x).sum()                        # b * x made and freed
        del b
        live.append(mem.live)                    # the graph saves b
        d = torch.empty(2 * N, device=META)
        live.append(mem.live)                    # 3 MB + 4
        del d
        return c

    res = oa.analyze_ops(prog, x)
    assert live == [MB, MB, 0, MB + 4, 3 * MB + 4]
    assert res.peak_bytes == 3 * MB + 4


def test_record_kernel_and_quiet():
    with oa.OpCounter() as c:
        oa.record_kernel("k", 10.0, 20.0)
        with c.quiet():
            torch.ones(4, device=META) + 1
    assert (c.cost.flops, c.cost.hbm_bytes, c.cost.ops) == (10.0, 20.0,
                                                            {"k": 1})
    oa.record_kernel("k", 1.0, 1.0)          # no counter: nothing happens
    assert oa.active is None


def test_collectives_are_zero_on_one_card():
    a = torch.empty(8, device=META)
    s = oa.analyze_collectives(lambda t: t * 2, a)
    assert s == {"total_bytes": 0.0, "bytes_by_kind": {}, "count_by_kind": {}}


def test_collective_bytes_from_the_c10d_ops(tmp_path):
    """Eager and functional collectives on a one-process gloo group:
    each counted by kind with its output bytes."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0)
    try:
        x, y = torch.ones(16), torch.empty(16)

        def step(x):
            dist.all_reduce(x)
            dist.all_gather_into_tensor(y, x)
            return fc.wait_tensor(fc.all_reduce(x, "sum", dist.group.WORLD))
        s = oa.analyze_collectives(step, x)
    finally:
        if own:
            dist.destroy_process_group()
    assert s == {"total_bytes": 192.0,
                 "bytes_by_kind": {"all-reduce": 128.0, "all-gather": 64.0},
                 "count_by_kind": {"all-reduce": 2, "all-gather": 1}}


def test_op_cost_add():
    a = oa.OpCost(1.0, 2.0, 3.0, {"all-reduce": 4.0}, {"all-reduce": 1}, 1,
                  {"aten.mm.default": 2})
    b = oa.OpCost()
    b.add(a, 3)
    assert (b.flops, b.hbm_bytes, b.collective_bytes) == (3.0, 6.0, 9.0)
    assert b.collective_bytes_by_kind == {"all-reduce": 12.0}
    assert b.collective_count_by_kind == {"all-reduce": 3}
    assert b.ops == {"aten.mm.default": 6} and b.n_loops == 1


# ---------------------------------------------------------------------------
# reduced cells: trip-weighted meta count == full CPU count
# ---------------------------------------------------------------------------
S, B = 64, 2


@pytest.fixture
def one_thread():
    """The cells' tensors are tiny: one intra-op thread runs them fastest
    and leaves the other cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def short_chunks(monkeypatch, one_thread):
    """Every routed loop at >= 4 trips at S 64; AdamW's last chunk
    ragged."""
    monkeypatch.setattr(attention, "Q_CHUNK", 16)
    monkeypatch.setattr(attention, "KV_CHUNK", 16)
    monkeypatch.setattr(transformer, "LOSS_CHUNK", 16)
    monkeypatch.setattr(scan_utils, "SCAN_CHUNK", 16)
    monkeypatch.setattr(adam, "UPDATE_CHUNK", 3000)


def cell_config(arch: str):
    cfg = get_config(arch)
    n = len(cfg.blocks)
    return reduced(cfg, d_model=64, layers=4 if n == 1 else n).scaled(
        xlstm_chunk=16)


def _filled(tree, seed: int):
    g = torch.Generator().manual_seed(seed)

    def fill(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(1, 60, t.shape, generator=g, dtype=t.dtype)
        if t.dtype == torch.int8:
            return torch.randint(-9, 10, t.shape, generator=g, dtype=t.dtype)
        return (torch.randn(t.shape, generator=g) * 0.05).to(t.dtype)
    return tree_map(fill, tree)


def counts(cfg, kind: str, quant: bool):
    shape = ShapeSpec("reduced", kind, S, B)
    mesh = make_production_mesh()

    def cell():
        fn, args, _, _ = steps.make_cell(cfg, shape, mesh, quant=quant)
        return fn, (args[:3] + (S - 1,) if kind == "decode" else args)
    fn, args = cell()
    weighted = oa.analyze_ops(fn, *args, flop_counter=True)
    fn, args = cell()
    args = _filled(args, 0)
    if kind == "train":
        args[0]["step"].zero_()
    full = oa.analyze_ops(fn, *args, flop_counter=True)
    return weighted, full


def assert_equal_counts(weighted, full):
    assert weighted.cost.ops == full.cost.ops
    assert weighted.cost.flops == full.cost.flops > 0
    assert weighted.cost.hbm_bytes == full.cost.hbm_bytes > 0
    assert weighted.cost.collective_bytes == full.cost.collective_bytes == 0
    assert weighted.cost.n_loops == full.cost.n_loops


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_weighted_meta_count_equals_full_cpu_count(arch, kind, short_chunks):
    weighted, full = counts(cell_config(arch), kind, quant=False)
    assert_equal_counts(weighted, full)
    # every op the counter gives flops is one FlopCounterMode counts
    assert full.cost.flops == full.flop_counter
    assert weighted.peak_bytes == full.peak_bytes


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_weighted_meta_count_equals_full_cpu_count_w8a8(arch, kind,
                                                        short_chunks):
    """Each W8A8 product is one `w8a8_dense` / `w8a8_bmm` kernel in the
    tally; on the CPU FlopCounterMode sees its plain version's product
    (the same 2 M N K), so the totals still agree."""
    weighted, full = counts(cell_config(arch), kind, quant=True)
    assert_equal_counts(weighted, full)
    assert full.cost.ops.get("w8a8_dense", 0) > 0
    assert full.cost.flops == full.flop_counter
