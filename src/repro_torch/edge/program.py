"""EdgeProgram — the MCU export IR, NumPy only.

The port's own copy of the reference's `repro.edge.program`: it writes
and reads `.capsbin` files byte for byte as the reference does, so an
artifact crosses between the two packages in both directions.

A compiled CapsNet is a flat schedule of three op kinds (`CONV_Q7`,
`PRIMARY_CAPS_Q7`, `CAPS_ROUTING_Q7`) over per-sample activation
tensors.  Every op record carries exactly the Qm.n formats, power-of-two
shifts, and int8 weight blobs of the typed plan it was lowered from —
nothing is re-derived downstream, so the VM, the arena planner, and the
C emitter all read one source of truth.

Serialization is a single binary artifact (`.capsbin`) holding a JSON
header plus 16-byte-aligned raw weight blobs, with the same header also
written next to it as a human-readable `.manifest.json`.  `load()` reads
the `.capsbin` alone and round-trips bit-exactly (`same_as`).
"""
from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path

import numpy as np

MAGIC = b"CAPSBIN\x01"
VERSION = 1
_ALIGN = 16

OP_KINDS = ("CONV_Q7", "PRIMARY_CAPS_Q7", "CAPS_ROUTING_Q7")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One activation tensor: per-sample shape (no batch dim) + format."""
    tid: int
    name: str                       # e.g. "input", "conv0.out"
    shape: tuple                    # ints, per sample
    frac: int                       # Qm.n fractional bits of the int8 data

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self) -> int:        # activations are always int8
        return self.size


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeOp:
    """One schedule entry: kind + attrs (ints / int tuples / strings,
    JSON-safe) + named weight blobs (int8/int32 numpy arrays)."""
    kind: str
    name: str
    inputs: tuple                   # tensor ids read
    output: int                     # tensor id written
    attrs: dict
    weights: dict

    def __post_init__(self):
        if self.kind not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.kind!r}; "
                             f"have {OP_KINDS}")

    @property
    def weight_bytes(self) -> int:
        return sum(int(w.nbytes) for w in self.weights.values())

    def attr_scalars(self) -> int:
        """int32 table entries this op needs at runtime (shifts/formats);
        the flash-side analogue of plans.plan_scalars."""
        n = 0
        for v in self.attrs.values():
            if isinstance(v, bool):
                continue
            if isinstance(v, int):
                n += 1
            elif isinstance(v, tuple):
                n += len(v)
        return n


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeProgram:
    name: str
    rounding: str                   # "floor" | "nearest"
    input_frac: int
    tensors: tuple                  # TensorSpec, indexed by tid
    ops: tuple                      # EdgeOp, in execution order

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def tensor(self, tid: int) -> TensorSpec:
        t = self.tensors[tid]
        assert t.tid == tid
        return t

    @property
    def input_tensor(self) -> TensorSpec:
        return self.tensors[0]

    @property
    def output_tensor(self) -> TensorSpec:
        return self.tensor(self.ops[-1].output)

    @property
    def weight_bytes(self) -> int:
        return sum(op.weight_bytes for op in self.ops)

    @property
    def flash_bytes(self) -> int:
        """Read-only footprint: int8 weights + the int32 shift/format
        tables (1 for input_frac + each op's attr scalars)."""
        return self.weight_bytes + 4 * (1 + sum(op.attr_scalars()
                                                for op in self.ops))

    def same_as(self, other: "EdgeProgram") -> bool:
        """Structural + bit equality (dataclass eq is off: numpy leaves)."""
        if self.header() != other.header():
            return False
        for a, b in zip(self.ops, other.ops):
            for k in a.weights:
                if a.weights[k].dtype != b.weights[k].dtype or \
                        not np.array_equal(a.weights[k], b.weights[k]):
                    return False
        return True

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def header(self) -> dict:
        """The JSON header/manifest (everything but the blob payloads)."""
        ops = []
        offset = 0
        for op in self.ops:
            wmeta = {}
            for wname in sorted(op.weights):
                w = op.weights[wname]
                offset = _align(offset)
                wmeta[wname] = {"dtype": str(w.dtype),
                                "shape": list(w.shape),
                                "offset": offset,
                                "nbytes": int(w.nbytes)}
                offset += int(w.nbytes)
            ops.append({"kind": op.kind, "name": op.name,
                        "inputs": list(op.inputs), "output": op.output,
                        "attrs": _attrs_to_json(op.attrs),
                        "weights": wmeta})
        return {
            "format": "capsbin", "version": VERSION,
            "name": self.name, "rounding": self.rounding,
            "input_frac": self.input_frac,
            "tensors": [{"tid": t.tid, "name": t.name,
                         "shape": list(t.shape), "frac": t.frac}
                        for t in self.tensors],
            "ops": ops,
        }

    def save(self, stem) -> dict:
        """Write `<stem>.capsbin` + `<stem>.manifest.json`; return paths."""
        stem = Path(stem)
        stem.parent.mkdir(parents=True, exist_ok=True)
        header = self.header()
        hbytes = json.dumps(header, sort_keys=True).encode()
        payload = bytearray()
        for op in self.ops:
            for wname in sorted(op.weights):
                while len(payload) % _ALIGN:
                    payload.append(0)
                payload += op.weights[wname].tobytes()
        blob = MAGIC + struct.pack("<I", len(hbytes)) + hbytes
        blob += b"\x00" * (_align(len(blob)) - len(blob))
        blob += bytes(payload)

        capsbin = stem.with_suffix(".capsbin")
        manifest = stem.with_suffix(".manifest.json")
        capsbin.write_bytes(blob)
        manifest.write_text(json.dumps(header, sort_keys=True, indent=2)
                            + "\n")
        return {"capsbin": capsbin, "manifest": manifest}

    @classmethod
    def load(cls, path) -> "EdgeProgram":
        raw = Path(path).read_bytes()
        if raw[:len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a capsbin artifact")
        (hlen,) = struct.unpack_from("<I", raw, len(MAGIC))
        hstart = len(MAGIC) + 4
        header = json.loads(raw[hstart:hstart + hlen].decode())
        if header.get("version") != VERSION:
            raise ValueError(f"{path}: capsbin version "
                             f"{header.get('version')} != {VERSION}")
        payload = raw[_align(hstart + hlen):]

        tensors = tuple(TensorSpec(t["tid"], t["name"], tuple(t["shape"]),
                                   t["frac"]) for t in header["tensors"])
        ops = []
        for o in header["ops"]:
            weights = {}
            for wname, m in o["weights"].items():
                # the header's blob metadata must be internally
                # consistent with the payload BEFORE frombuffer touches
                # it — a tampered shape/nbytes/offset is a loud
                # malformed-artifact error, not a silent misread
                count = int(np.prod(m["shape"], dtype=np.int64))
                want = count * np.dtype(m["dtype"]).itemsize
                if int(m["nbytes"]) != want:
                    raise ValueError(
                        f"{path}: blob {o['name']}/{wname} declares "
                        f"{m['nbytes']} bytes but shape {m['shape']} x "
                        f"{m['dtype']} needs {want}")
                if m["offset"] < 0 or m["offset"] + want > len(payload):
                    raise ValueError(
                        f"{path}: blob {o['name']}/{wname} at offset "
                        f"{m['offset']} (+{want}B) runs past the "
                        f"{len(payload)}-byte payload")
                a = np.frombuffer(payload, dtype=np.dtype(m["dtype"]),
                                  count=count, offset=m["offset"])
                weights[wname] = a.reshape(m["shape"]).copy()
            ops.append(EdgeOp(o["kind"], o["name"], tuple(o["inputs"]),
                              o["output"], _attrs_from_json(o["attrs"]),
                              weights))
        return cls(name=header["name"], rounding=header["rounding"],
                   input_frac=header["input_frac"], tensors=tensors,
                   ops=tuple(ops))


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _attrs_to_json(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, tuple):
            out[k] = {"tuple": [int(x) for x in v]}
        elif isinstance(v, (bool, int, str)):
            out[k] = v
        else:
            raise TypeError(f"attr {k}={v!r} is not JSON-safe")
    return out


def _attrs_from_json(attrs: dict) -> dict:
    return {k: tuple(v["tuple"]) if isinstance(v, dict) else v
            for k, v in attrs.items()}
