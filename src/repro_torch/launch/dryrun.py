"""The dry run; the counterpart of `repro.launch.dryrun`.

For every (architecture x input shape x mesh) cell:
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
those of the counted run.

The meshes are `launch.mesh.make_production_mesh`'s: `single`, one card,
and `multi`, (pod 2, data 32, model 8) over 512 cards.  A mesh of more
than one card is counted for one rank, rank 0, inside a
`dist.world.fake_world` of the mesh's size: the step runs on the rank's
shares of its inputs (`steps.local_structs`), its collectives dispatch
over the mesh's groups and move nothing, and each is counted with its
bytes on the fabric it crosses.  Contiguous shares give index 0 the
largest share of every axis, so rank 0's bound and memory are the worst
rank's.  Results land as JSON in
build/dryrun/<arch>__<shape>__<mesh>[__w8a8][__tag].json (resumable:
existing artifacts are skipped unless --force).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_14b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--quant] \
      [--mesh single|multi|both]
"""
import argparse
import contextlib
import json
import pathlib
import time
import traceback

from repro_torch.configs.base import (ARCH_IDS, SHAPES, cell_is_runnable,
                                      get_config)
from repro_torch.dist import api
from repro_torch.dist.api import Mesh
from repro_torch.dist.op_analysis import analyze_ops
from repro_torch.dist.world import fake_world
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.roofline import analyze_cell
from repro_torch.models.transformer import build_model
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
                 quant: bool = False, *, mesh=None, rank: int = 0,
                 pos=None) -> tuple:
    """(record, OpCost) of the cell's step on meta tensors: the roofline
    record of `analyze_cell` with `lower_s` and `compile_s`, and the
    trip-weighted cost with its tally by op.  `mesh` is a record of any
    axes (default: the production mesh of `mesh_kind`); over more than
    one device the step counted is rank `rank`'s, in a fake world of the
    mesh's size, and the record says which rank.  A decode step decodes
    at `pos` (default the shape's last slot)."""
    layout = mesh or make_production_mesh(multi_pod=(mesh_kind == "multi"))
    with contextlib.ExitStack() as stack:
        if layout.size > 1:
            world = stack.enter_context(fake_world(layout.size, rank))
            mesh = Mesh(layout.axis_names, layout.sizes, world.devices,
                        world=world)
        else:
            mesh = layout
        t0 = time.time()
        # made outside `with mesh`, which would cut the caches' slots to
        # the rank's share: the structs stay global, as make_cell says
        fn, args, in_specs, _ = steps.make_cell(cfg, shape, mesh,
                                                quant=quant)
        known = None
        if shape.kind == "decode":    # the whole caches' slots
            known = build_model(cfg).slot_counts(args[1])
        if mesh.world is not None:
            args = steps.local_structs(args, in_specs, mesh)
        if shape.kind == "decode":
            args = args[:3] + (shape.seq_len - 1 if pos is None else pos,)
        t1 = time.time()
        stack.enter_context(api.known_sizes(known))
        arg = _storages(list(args))
        donated = _storages([args[i] for i in donate_for(shape.kind)])
        res = analyze_ops(fn, *args, flop_counter=True)
        t2 = time.time()
        memory = memory_of(arg, donated, res.out, res.peak_bytes)
        print(memory)
        print({"flops": res.cost.flops, "bytes accessed": res.cost.hbm_bytes})
        rec = analyze_cell(res.cost, memory, cfg, shape, mesh_chips(mesh),
                           mesh_kind, int8=quant,
                           flop_counter_raw=res.flop_counter)
        if mesh.world is not None:
            rec["rank"] = rank
    rec.update(lower_s=round(t1 - t0, 2), compile_s=round(t2 - t1, 2))
    return rec, res.cost


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
                    default="both",
                    help="single: one card; multi: (pod 2, data 32, model "
                    "8) over 512, rank 0 counted")
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

    outdir = pathlib.Path(args.out)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = list(SHAPES) if (args.all or not args.shape) else (args.shape,)

    n_err = 0
    for arch in archs:
        for shape in shapes:
            override = None
            if args.kv8:
                override = get_config(arch).scaled(kv_cache_int8=True)
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind, outdir, args.force,
                               quant=args.quant, tag=args.tag,
                               arch_override=override)
                n_err += rec.get("status") == "error"
    print(f"done; {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
