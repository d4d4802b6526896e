"""CMSIS-NN-style C emitter for `EdgeProgram`s.

Emits a self-contained `.c`/`.h` pair in the idiom of the paper's
deployment target: `const q7_t` weight arrays in flash, the shift and
format decisions as `#define`s, a static activation arena laid out by
the planner, and an ordered layer-call schedule against the paper's
kernel API — `arm_convolve_HWC_q7_basic` / `arm_relu_q7` from CMSIS-NN
plus the paper's capsule extensions (`capsnet_squash_q7`,
`capsnet_dynamic_routing_q7`, and the per-channel conv variant).  The
kernel implementations are the MCU vendor library's; the generated file
declares their prototypes so the artifact documents the exact contract.

Output is deterministic for a given program and byte-identical to the
reference's `repro.edge.emit_c` (both are held against the golden files
in tests/golden/): the generated text names the reference's modules,
so an artifact reads the same whichever package wrote it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from repro_torch.edge.arena import ArenaPlan, plan_arena
from repro_torch.edge.program import EdgeOp, EdgeProgram
from repro_torch.nn.variants import REGISTRY as _VARIANTS

_PER_LINE = 12

_PROTOTYPES = """\
/* CMSIS-NN kernels (vendor library).  Shifts are int16_t, not CMSIS's
 * uint16_t: virtual Qm.n formats (paper Sec. 4) make bias_shift negative
 * when the bias format exceeds the accumulator's, meaning a right
 * shift of the bias instead of a left one. */
void arm_convolve_HWC_q7_basic(const q7_t *Im_in, uint16_t dim_im_in,
    uint16_t ch_im_in, const q7_t *wt, uint16_t ch_im_out,
    uint16_t dim_kernel, uint16_t padding, uint16_t stride,
    const q7_t *bias, int16_t bias_shift, int16_t out_shift,
    q7_t *Im_out, uint16_t dim_im_out, q15_t *bufferA, q7_t *bufferB);
void arm_relu_q7(q7_t *data, uint16_t size);
/* paper extensions to CMSIS-NN (Alg. 4/5, Eq. 8) */
void capsnet_convolve_HWC_q7_per_channel(const q7_t *Im_in,
    uint16_t dim_im_in, uint16_t ch_im_in, const q7_t *wt,
    uint16_t ch_im_out, uint16_t dim_kernel, uint16_t padding,
    uint16_t stride, const q7_t *bias, const int8_t *bias_shift_per_ch,
    const int8_t *out_shift_per_ch, q7_t *Im_out, uint16_t dim_im_out,
    q15_t *bufferA, q7_t *bufferB);
void capsnet_squash_q7(q7_t *caps, uint16_t num_caps, uint16_t caps_dim,
    uint16_t in_frac, uint16_t out_frac);
void capsnet_dynamic_routing_q7(const q7_t *u, const q7_t *W,
    uint16_t num_out, uint16_t num_in, uint16_t out_dim,
    uint16_t in_dim, uint16_t routings, int16_t uhat_shift,
    uint16_t logit_frac, const int8_t *caps_out_shifts,
    const int8_t *caps_out_fracs, const int8_t *agree_shifts,
    uint16_t squash_out_frac, q7_t *v_out, q7_t *bufferA);
"""

_SQUASH_PROTO = """\
void {sym}(q7_t *caps, uint16_t num_caps, uint16_t caps_dim,
    uint16_t in_frac, uint16_t out_frac);"""

_ROUTING_PROTO = """\
void {sym}(const q7_t *u, const q7_t *W,
    uint16_t num_out, uint16_t num_in, uint16_t out_dim,
    uint16_t in_dim, uint16_t routings, int16_t uhat_shift,
    uint16_t logit_frac, const int8_t *caps_out_shifts,
    const int8_t *caps_out_fracs, const int8_t *agree_shifts,
    uint16_t squash_out_frac, q7_t *v_out, q7_t *bufferA);"""

# per-output-capsule W formats (RoutingPlan.per_out): the u_hat
# requantization shift becomes a length-num_out table, one entry per
# output capsule (the routing analogue of the per-channel conv)
_ROUTING_PER_OUT_PROTO = """\
void {sym}(const q7_t *u, const q7_t *W,
    uint16_t num_out, uint16_t num_in, uint16_t out_dim,
    uint16_t in_dim, uint16_t routings,
    const int8_t *uhat_shift_per_out,
    uint16_t logit_frac, const int8_t *caps_out_shifts,
    const int8_t *caps_out_fracs, const int8_t *agree_shifts,
    uint16_t squash_out_frac, q7_t *v_out, q7_t *bufferA);"""


def _variant(kind: str, attrs: dict):
    return _VARIANTS.from_attrs(kind, attrs)


def _squash_symbol(attrs: dict) -> str:
    return _variant("squash", attrs).c_symbol


def _routing_symbol(attrs: dict) -> str:
    """The routing kernel symbol, suffixed per non-default operator
    variant (the ISLPED'22 approximate kernels are distinct entry
    points, so the artifact documents exactly which arithmetic ran) and
    per-out when the plan carries per-output-capsule W formats."""
    sym = ("capsnet_dynamic_routing_q7"
           + _variant("softmax", attrs).c_suffix
           + _variant("squash", attrs).c_suffix)
    if attrs.get("uhat_shift_per_out"):
        sym += "_per_out"
    return sym


def _variant_prototypes(program: EdgeProgram) -> list:
    """Prototypes for non-default variant kernels the schedule calls
    (deterministic: schedule order, deduped)."""
    protos = []
    for op in program.ops:
        if op.kind == "PRIMARY_CAPS_Q7" \
                and _variant("squash", op.attrs).c_suffix:
            protos.append(_SQUASH_PROTO.format(
                sym=_squash_symbol(op.attrs)))
        elif op.kind == "CAPS_ROUTING_Q7":
            sym = _routing_symbol(op.attrs)
            if sym != "capsnet_dynamic_routing_q7":
                proto = _ROUTING_PER_OUT_PROTO \
                    if op.attrs.get("uhat_shift_per_out") else _ROUTING_PROTO
                protos.append(proto.format(sym=sym))
    if not protos:
        return []
    seen, out = set(), ["/* ISLPED'22 approximate-operator variants "
                        "(repro.nn.variants) */"]
    for p in protos:
        if p not in seen:
            seen.add(p)
            out.append(p)
    out.append("")
    return out


def _carray(name: str, arr: np.ndarray, ctype: str) -> str:
    flat = arr.reshape(-1)
    lines = [f"const {ctype} {name}[{flat.size}] = {{"]
    for i in range(0, flat.size, _PER_LINE):
        chunk = ", ".join(str(int(v)) for v in flat[i:i + _PER_LINE])
        tail = "," if i + _PER_LINE < flat.size else ""
        lines.append(f"    {chunk}{tail}")
    lines.append("};")
    return "\n".join(lines)


def _defines(prefix: str, attrs: dict, keys) -> list:
    return [f"#define {prefix}_{k.upper()} {attrs[k]}"
            for k in keys if k in attrs]


def _shift_table(prefix: str, key: str, values) -> str:
    return _carray(f"{prefix}_{key}", np.asarray(values, np.int8),
                   "int8_t")


def _conv_call(op: EdgeOp, prog: EdgeProgram, src: str, dst: str) -> list:
    a, p = op.attrs, op.name
    dim_in = prog.tensor(op.inputs[0]).shape[0]     # square feature maps
    out_t = prog.tensor(op.output)
    # PRIMARY_CAPS output is [n_caps, dim]; its conv writes the same
    # buffer at the conv's square spatial dim before the in-place squash
    dim_out = out_t.shape[0] if len(out_t.shape) == 3 else \
        int(round((out_t.size // a["out_ch"]) ** 0.5))
    per_ch = bool(a.get("out_shift_per_channel"))
    fn = "capsnet_convolve_HWC_q7_per_channel" if per_ch \
        else "arm_convolve_HWC_q7_basic"
    bias_arg = f"{p}_bias_shift_per_ch" if per_ch \
        else f"{p.upper()}_BIAS_SHIFT"
    out_arg = f"{p}_out_shift_per_ch" if per_ch \
        else f"{p.upper()}_OUT_SHIFT"
    return [
        f"    {fn}({src}, {dim_in}, {a['in_ch']}, {p}_w, {a['out_ch']},",
        f"        {a['kernel']}, 0, {a['stride']}, {p}_b, {bias_arg},",
        f"        {out_arg}, {dst}, {dim_out}, scratch, NULL);",
    ]


def _emit_op(op: EdgeOp, prog: EdgeProgram, plan: ArenaPlan) -> list:
    def buf(tid: int) -> str:
        if tid == 0:
            return "input"
        off = plan.offsets[tid]
        return f"arena + {off}" if off else "arena"

    src, dst = buf(op.inputs[0]), buf(op.output)
    out_t = prog.tensor(op.output)
    lines = [f"    /* {op.name}: {op.kind} -> "
             f"{'x'.join(str(d) for d in out_t.shape)} q{out_t.frac} */"]
    a, p = op.attrs, op.name
    if op.kind == "CONV_Q7":
        lines += _conv_call(op, prog, src, dst)
        if a["relu"]:
            lines.append(f"    arm_relu_q7({dst}, {out_t.size});")
    elif op.kind == "PRIMARY_CAPS_Q7":
        lines += _conv_call(op, prog, src, dst)
        n_caps, dim = out_t.shape
        lines.append(
            f"    {_squash_symbol(a)}({dst}, {n_caps}, {dim}, "
            f"{p.upper()}_SQUASH_IN_FRAC, {p.upper()}_SQUASH_OUT_FRAC);")
    elif op.kind == "CAPS_ROUTING_Q7":
        uhat_arg = f"{p}_uhat_shift_per_out" \
            if a.get("uhat_shift_per_out") else f"{p.upper()}_UHAT_SHIFT"
        lines += [
            f"    {_routing_symbol(a)}({src}, {p}_W, {a['num_out']},",
            f"        {a['num_in']}, {a['out_dim']}, {a['in_dim']}, "
            f"{a['routings']},",
            f"        {uhat_arg}, {p.upper()}_LOGIT_FRAC, "
            f"{p}_caps_out_shifts,",
            f"        {p}_caps_out_fracs, {p}_agree_shifts, "
            f"{p.upper()}_SQUASH_OUT_FRAC,",
            f"        {dst}, (q7_t *)scratch);",
        ]
    return lines


_CONV_DEFINE_KEYS = ("kernel", "stride", "in_ch", "out_ch", "in_frac",
                     "w_frac", "b_frac", "out_frac", "out_shift",
                     "bias_shift")
_PCAP_DEFINE_KEYS = _CONV_DEFINE_KEYS + ("caps", "dim", "squash_in_frac",
                                         "squash_out_frac")
_ROUTING_DEFINE_KEYS = ("num_out", "num_in", "out_dim", "in_dim",
                        "routings", "in_frac", "W_frac", "uhat_frac",
                        "uhat_shift", "logit_frac", "squash_out_frac")


def emit_c(program: EdgeProgram, plan: ArenaPlan | None = None) -> dict:
    """Return {"c": str, "h": str} for the program (+arena plan)."""
    plan = plan or plan_arena(program)
    stem = program.name
    guard = f"CAPSNET_{stem.upper()}_H"
    scratch = plan.scratch_bytes    # 2-byte aligned by plan_arena

    # ---------------- header ----------------
    h = [f"/* Auto-generated by repro.edge.emit_c from EdgeProgram "
         f"{stem!r}.", f" * Schedule: "
         + " -> ".join(op.name for op in program.ops)
         + f"; rounding={program.rounding}.", " * Do not edit. */",
         f"#ifndef {guard}", f"#define {guard}", "",
         "#include <stdint.h>", "",
         "typedef int8_t q7_t;", "typedef int16_t q15_t;",
         "typedef int32_t q31_t;", "",
         f"#define {stem.upper()}_INPUT_FRAC {program.input_frac}",
         f"#define {stem.upper()}_INPUT_BYTES "
         f"{program.input_tensor.size}",
         f"#define {stem.upper()}_OUTPUT_BYTES "
         f"{program.output_tensor.size}",
         f"#define {stem.upper()}_ARENA_BYTES {plan.arena_bytes}",
         f"#define {stem.upper()}_SCRATCH_BYTES {scratch}", ""]
    c = [f'#include "{stem}.h"', ""]

    for op in program.ops:
        a, p = op.attrs, op.name
        keys = {"CONV_Q7": _CONV_DEFINE_KEYS,
                "PRIMARY_CAPS_Q7": _PCAP_DEFINE_KEYS,
                "CAPS_ROUTING_Q7": _ROUTING_DEFINE_KEYS}[op.kind]
        h.append(f"/* {p}: {op.kind} */")
        h += _defines(p.upper(), a, keys)
        for wname in sorted(op.weights):
            w = op.weights[wname]
            ctype = "q7_t" if w.dtype == np.int8 else "q31_t"
            h.append(f"extern const {ctype} {p}_{wname}[{w.size}];")
            c.append(_carray(f"{p}_{wname}", w, ctype))
            c.append("")
        for key in ("out_shift_per_channel", "bias_shift_per_channel"):
            if a.get(key):
                short = key.replace("_per_channel", "_per_ch")
                h.append(f"extern const int8_t {p}_{short}"
                         f"[{len(a[key])}];")
                c.append(_shift_table(p, short, a[key]))
                c.append("")
        for key in ("caps_out_shifts", "caps_out_fracs", "agree_shifts",
                    "W_frac_per_out", "uhat_shift_per_out"):
            if key in a:
                h.append(f"extern const int8_t {p}_{key}[{len(a[key])}];")
                c.append(_shift_table(p, key, a[key]))
                c.append("")
        h.append("")

    h += [_PROTOTYPES]
    h += _variant_prototypes(program)
    h += [f"void {stem}_run(const q7_t *input, q7_t *output);", "",
          f"#endif /* {guard} */", ""]

    # ---------------- run function ----------------
    # scratch is declared q15_t so the conv bufferA cast is always
    # 2-byte aligned (a q7_t array may land on an odd address)
    c += [f"static q7_t arena[{stem.upper()}_ARENA_BYTES];",
          f"static q15_t scratch[({stem.upper()}_SCRATCH_BYTES + 1) / 2];",
          "",
          f"void {stem}_run(const q7_t *input, q7_t *output)", "{"]
    for op in program.ops:
        c += _emit_op(op, program, plan)
    out = program.ops[-1].output
    off = plan.offsets[out]
    src = f"arena + {off}" if off else "arena"
    c += [f"    for (int i = 0; i < {stem.upper()}_OUTPUT_BYTES; i++)",
          f"        output[i] = ({src})[i];", "}", ""]

    return {"c": "\n".join(c), "h": "\n".join(h)}


def save_c(program: EdgeProgram, out_dir, plan: ArenaPlan | None = None
           ) -> dict:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    src = emit_c(program, plan)
    paths = {"c": out_dir / f"{program.name}.c",
             "h": out_dir / f"{program.name}.h"}
    paths["c"].write_text(src["c"])
    paths["h"].write_text(src["h"])
    return paths
