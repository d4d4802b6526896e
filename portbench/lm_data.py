"""The inputs of a language-model run, drawn from `--seed`: the float
weights, leaf by leaf, and the pool of prompts; and the one generator of
LM traffic, which reads a cell's parameters (`workloads/<cell>.json`).

Weights.  Every leaf has a generator of its own on the device, seeded
from (seed, the leaf's path, its cycle), so a leaf is drawn alone and the
same whenever it is drawn: once in set-up, where the program quantizes
it, and again after the window, where the reference quantizes it itself.
A leaf is drawn in float32 in one call, scaled, and cast to the type it
is served from: bf16 for the products' weights and the embedding (a bf16
checkpoint put through the port's W8A8 quantization), float32 for the
router and the norms.  Scales: 1/sqrt(fan-in) for every product, the
router and the embedding; the norms' scale N(0, 0.1) about the port's
(1 + scale), so every norm weight carries a value.

Traffic ("waves", the only kind): a closed loop of whole waves.  Wave w
takes `batch` prompts of the pool, by a permutation drawn from the seed,
prefills them and decodes `gen` greedy tokens each.  Prompts are
`prompt_len` token ids, uniform over the vocabulary.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch

KINDS = ("waves",)
NORM_STD = 0.1

# scale of a leaf by its name, given the configuration's sizes
_FAN_IN = {"wq": "d", "wk": "d", "wv": "d", "wo": "q", "router": "d",
           "w_gate": "d", "w_up": "d", "w_down": "f", "table": "d",
           "w": "d"}


@dataclasses.dataclass(frozen=True)
class Waves:
    kind: str
    batch: int
    prompt_len: int
    gen: int
    pool: int

    @classmethod
    def of(cls, params: dict) -> "Waves":
        t = cls(kind=params["kind"], batch=int(params["batch"]),
                prompt_len=int(params["prompt_len"]),
                gen=int(params["gen"]), pool=int(params["pool"]))
        if t.kind not in KINDS:
            raise ValueError(f"LM traffic kind {t.kind!r}; have {KINDS}")
        if min(t.batch, t.prompt_len, t.gen) < 1 or t.pool < t.batch:
            raise ValueError(f"LM traffic needs batch, prompt_len, gen >= 1 "
                             f"and pool >= batch: {params}")
        return t

    def rows(self, seed: int, wave: int) -> list:
        """The pool rows of wave `wave`: consecutive slices of one
        permutation of the pool drawn from the seed, a new permutation
        each pass."""
        per_pass = self.pool // self.batch
        p, k = divmod(wave, per_pass)
        g = torch.Generator().manual_seed(leaf_seed(seed, "waves", p))
        perm = torch.randperm(self.pool, generator=g)
        return perm[k * self.batch:(k + 1) * self.batch].tolist()


def leaf_seed(seed: int, path: str, cycle: int) -> int:
    """A 63-bit seed for one leaf of one cycle (any whole `seed`)."""
    h = hashlib.sha256(f"{int(seed)}/{path}/{int(cycle)}".encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def scale(name: str, sizes: dict) -> float:
    return sizes[_FAN_IN[name]] ** -0.5


def draw_leaf(seed: int, path: str, cycle: int, shape, dtype, sizes: dict,
              device) -> torch.Tensor:
    """One leaf: float32 N(0, 1) from its own generator, scaled (a norm's
    scale: N(0, NORM_STD)), cast to `dtype`."""
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, path, cycle))
    x = torch.randn(tuple(shape), generator=g, dtype=torch.float32,
                    device=device)
    name = path.rsplit("/", 1)[-1]
    x.mul_(NORM_STD if name == "scale" else scale(name, sizes))
    return x.to(dtype)


def prompts(seed: int, traffic: Waves, vocab: int, device) -> torch.Tensor:
    """The pool: int64 [pool, prompt_len] token ids, uniform over the
    vocabulary, in one draw on the device."""
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, "prompts", 0))
    return torch.randint(0, vocab, (traffic.pool, traffic.prompt_len),
                         generator=g, device=device)
