"""The one-card dry run; the counterpart of `repro.launch.dryrun`.

For every (architecture x input shape) cell:
  fn, args = launch.steps.make_cell(cfg, shape, mesh)   # meta structs
  analysis = dist.op_analysis.analyze_ops(fn, *args)    # trip-weighted
  record   = launch.roofline.analyze_cell(...)          # H100 roofline
The step is the cell's real one, run on meta tensors: nothing is
allocated and no card is needed, as the reference's forced host devices
need no TPU.  Its loops are weighted by trip count (`op_analysis.
trip_scan`); memory comes from the live-bytes tracker (`temp`: the peak
of what the step allocates, less its new outputs) and the donated
inputs the step updates in place (`alias`: the train state, the decode
cache).  A decode cell decodes at the shape's last slot, seq_len - 1.
`lower_s` is the seconds to build the cell's structs and `compile_s`
those of the counted run.  Results land as JSON in
build/dryrun/<arch>__<shape>__<mesh>[__w8a8][__tag].json (resumable:
existing artifacts are skipped unless --force).  The mesh is one card:
`--mesh multi` and `both` exit 2 (ROADMAP Queue A, multi-card).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_14b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--quant]
"""
import argparse
import json
import pathlib
import time
import traceback

from repro_torch.configs.base import (ARCH_IDS, SHAPES, cell_is_runnable,
                                      get_config)
from repro_torch.dist.api import MULTI_CARD
from repro_torch.dist.op_analysis import analyze_ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.roofline import analyze_cell
from repro_torch.tree import leaves

DEFAULT_OUT = pathlib.Path("build/dryrun")


def donate_for(kind: str):
    if kind == "train":
        return (0,)       # state
    if kind == "decode":
        return (1,)       # cache
    return ()


def _storages(tree) -> dict:
    """{storage key: bytes} of the tensors of `tree`, each storage once."""
    out = {}
    for t in leaves(tree):
        if hasattr(t, "untyped_storage"):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def memory_of(arg: dict, donated: dict, out, peak: int) -> dict:
    """The reference's memory fields of a step whose arguments held the
    storages `arg` (`donated` of them donated), taken before it ran (it
    updates its state in place), that returned `out` and allocated at
    most `peak` live bytes."""
    outs = _storages(out)
    new_out = sum(nb for k, nb in outs.items() if k not in arg)
    return {"argument_size_in_bytes": sum(arg.values()),
            "output_size_in_bytes": sum(outs.values()),
            "temp_size_in_bytes": max(peak - new_out, 0),
            "alias_size_in_bytes": sum(nb for k, nb in outs.items()
                                       if k in donated),
            "generated_code_size_in_bytes": 0}


def analyze_step(cfg, shape, mesh_kind: str = "single",
                 quant: bool = False) -> tuple:
    """(record, OpCost) of the cell's step on meta tensors: the roofline
    record of `analyze_cell` with `lower_s` and `compile_s`, and the
    trip-weighted cost with its tally by op."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    with mesh:
        t0 = time.time()
        fn, args, _, _ = steps.make_cell(cfg, shape, mesh, quant=quant)
        if shape.kind == "decode":
            args = args[:3] + (shape.seq_len - 1,)
        t1 = time.time()
        arg = _storages(list(args))
        donated = _storages([args[i] for i in donate_for(shape.kind)])
        res = analyze_ops(fn, *args, flop_counter=True)
        t2 = time.time()
        memory = memory_of(arg, donated, res.out, res.peak_bytes)
        print(memory)
        print({"flops": res.cost.flops, "bytes accessed": res.cost.hbm_bytes})
        record = analyze_cell(res.cost, memory, cfg, shape, mesh_chips(mesh),
                              mesh_kind, int8=quant,
                              flop_counter_raw=res.flop_counter)
    record.update(lower_s=round(t1 - t0, 2), compile_s=round(t2 - t1, 2))
    return record, res.cost


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             outdir: pathlib.Path, force: bool = False,
             arch_override=None, quant: bool = False,
             tag: str = "") -> dict:
    outdir.mkdir(parents=True, exist_ok=True)
    suffix = ("__w8a8" if quant else "") + (f"__{tag}" if tag else "")
    path = outdir / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    if path.exists() and not force:
        rec = json.loads(path.read_text())
        print(f"[skip-existing] {path.name}: {rec.get('status')}")
        return rec

    cfg = arch_override or get_config(arch)
    shape = SHAPES[shape_name]
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "quant": quant, "tag": tag, "status": "?"}
    if quant and shape.kind == "train":
        record.update(status="skipped",
                      reason="W8A8 is a serving path (PTQ after training)")
        path.write_text(json.dumps(record, indent=1))
        return record
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=why)
        path.write_text(json.dumps(record, indent=1))
        print(f"[skipped ] {arch} x {shape_name} x {mesh_kind}: {why}")
        return record

    try:
        rec, _ = analyze_step(cfg, shape, mesh_kind, quant)
        record.update(rec, status="ok")
    except Exception as e:  # a failing cell is a bug: record it loudly
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"[ERROR   ] {arch} x {shape_name} x {mesh_kind}: {e}")
    path.write_text(json.dumps(record, indent=1, default=str))
    t = record.get("terms", {})
    if record["status"] == "ok":
        print(f"[ok {record['compile_s']:7.1f}s] {arch} x {shape_name} x "
              f"{mesh_kind}: dominant={record['dominant']} "
              f"frac={record['roofline_fraction']:.3f} "
              f"hbm={record['hbm_gib_per_dev']:.2f}GiB "
              f"terms={{c:{t['compute_s']:.4f},m:{t['memory_s']:.4f},"
              f"n:{t['collective_s']:.4f}}}")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single",
                    help="single: one card (multi and both are not "
                    f"ported: {MULTI_CARD})")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quant", action="store_true",
                    help="W8A8 parameter tree (prefill/decode cells)")
    ap.add_argument("--tag", default="",
                    help="artifact suffix for perf-iteration variants")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 KV cache (decode cells)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    if args.mesh != "single":
        print(f"--mesh {args.mesh}: a mesh of more than one card is not "
              f"ported yet ({MULTI_CARD})")
        raise SystemExit(2)

    outdir = pathlib.Path(args.out)
    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = list(SHAPES) if (args.all or not args.shape) else (args.shape,)

    n_err = 0
    for arch in archs:
        for shape in shapes:
            override = None
            if args.kv8:
                override = get_config(arch).scaled(kv_cache_int8=True)
            rec = run_cell(arch, shape, args.mesh, outdir, args.force,
                           quant=args.quant, tag=args.tag,
                           arch_override=override)
            n_err += rec.get("status") == "error"
    print(f"done; {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
