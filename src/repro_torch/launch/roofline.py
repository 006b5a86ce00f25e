"""Roofline derivation from dry-run counts, with H100 constants.

Port of ``repro.launch.roofline``. Three terms per (arch × shape × mesh)
cell, in seconds, for one NVIDIA H100 SXM:

    compute    = flops_per_device / 989e12        (bf16 dense tensor core)
    memory     = bytes_per_device / 3.35e12       (HBM3 bandwidth)
    collective = wire_bytes_per_device / 450e9    (NVLink 4, one direction)

``LINK_BW`` stands where the reference's per-link ICI rate stands. The
analogy is crude: the production meshes keep the reference's shapes, and
a 16-way ``model`` axis spans two 8-GPU NVLink domains of real H100 nodes,
so its collectives would cross the scale-out network, one 400 Gb/s
InfiniBand NDR port per GPU (50e9 bytes/s), not NVLink. The mesh shapes
are not changed here.

``collective_wire_bytes`` parses compiled HLO text and applies ring-
algorithm wire factors to each op's result shape (copied verbatim from the
reference): all-reduce 2× (reduce-scatter + all-gather phases),
all-gather 1× result, reduce-scatter 1×, all-to-all 1×,
collective-permute 1×. ``collective_wire_bytes_from_ops`` applies the same
factors to the collectives the port's dry-run records.

MODEL_FLOPS uses the kind-appropriate useful-work formula: train 6·N·D,
prefill 2·N·D, decode 2·N·tokens (N = active params for MoE); the ratio
against the counted FLOPs exposes remat/dispatch waste.
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12          # bf16 dense / H100 SXM
HBM_BW = 3.35e12             # bytes/s / H100 SXM
LINK_BW = 450e9              # bytes/s / GPU, NVLink 4, one direction

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
}

_COLLECTIVE_FACTORS = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# result type of a collective op:  `= bf16[8,128]{1,0} all-gather(` ; also
# tuple-shaped results `= (f32[4], f32[4]) all-reduce(`
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|\w+\[[\d,]*\][^ ]*)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_wire_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-device wire bytes by collective kind, from compiled HLO text."""
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVE_FACTORS}
    count = 0
    for m in _OP_RE.finditer(hlo_text):
        type_str, kind, started = m.group(1), m.group(2), m.group(3)
        if started and kind in ("all-reduce", "all-gather"):
            # -start ops: result tuple repeats operand; take half
            b = _shape_bytes(type_str) / 2
        else:
            b = _shape_bytes(type_str)
        out[kind] += b * _COLLECTIVE_FACTORS[kind]
        count += 1
    out["num_ops"] = count
    out["total"] = sum(v for k, v in out.items()
                       if k in _COLLECTIVE_FACTORS)
    return out



def collective_wire_bytes_from_ops(
        records: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """Per-device wire bytes by collective kind from ``(kind, result
    bytes)`` records (kind as in HLO: ``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``), with the
    same factors and keys as ``collective_wire_bytes``."""
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVE_FACTORS}
    count = 0
    for kind, nbytes in records:
        out[kind] += nbytes * _COLLECTIVE_FACTORS[kind]
        count += 1
    out["num_ops"] = count
    out["total"] = sum(v for k, v in out.items()
                       if k in _COLLECTIVE_FACTORS)
    return out

@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    hlo_flops_total: float
    useful_ratio: float
    collective_ops: int = 0
    model_flops_ext: float = 0.0   # incl. analytic attention quadratic
    useful_ratio_ext: float = 0.0  # model_flops_ext / HLO_FLOPs

    def as_dict(self):
        return asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n = cfg.active_param_count()
    toks = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * toks
    if shape.kind == "prefill":
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch          # decode: one token / seq


def attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic causal-attention FLOPs (qk + pv, lower triangle only) —
    the quadratic term 6·N·D misses, dominant at 32k+. For decode: one
    query row against the full cache."""
    if cfg.family == "ssm":
        return 0.0
    d_attn = cfg.num_heads * cfg.head_dim
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "hybrid":
        layers = cfg.num_layers // max(1, cfg.attn_every)
    elif cfg.is_encoder_decoder:
        layers = cfg.enc_layers + 2 * cfg.num_layers  # self + cross
    else:
        layers = cfg.num_layers
    if shape.kind == "decode":
        return 4.0 * B * S * d_attn * layers
    tri = 0.5 if not cfg.is_encoder_decoder else 1.0
    fwd = 4.0 * B * S * S * d_attn * layers * tri
    return 3.0 * fwd if shape.kind == "train" else fwd


def model_flops_ext(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D-style useful work INCLUDING the attention quadratic term."""
    return model_flops(cfg, shape) + attention_flops(cfg, shape)


def derive_from_parts(arch: str, shape: ShapeConfig, mesh_name: str,
                      num_devices: int, flops_dev: float, bytes_dev: float,
                      wires: Dict[str, float], cfg: ModelConfig) -> Roofline:
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = wires.get("total", 0.0) / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mflops = model_flops(cfg, shape)
    mext = model_flops_ext(cfg, shape)
    hlo_total = flops_dev * num_devices
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        wire_bytes_per_device=wires.get("total", 0.0),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops_total=mflops, hlo_flops_total=hlo_total,
        useful_ratio=(mflops / hlo_total) if hlo_total else 0.0,
        collective_ops=int(wires.get("num_ops", 0)),
        model_flops_ext=mext,
        useful_ratio_ext=(mext / hlo_total) if hlo_total else 0.0,
    )


def derive(arch: str, shape: ShapeConfig, mesh_name: str, num_devices: int,
           cost: Dict, hlo_text: str, cfg: ModelConfig) -> Roofline:
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    wires = collective_wire_bytes(hlo_text)
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = wires["total"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mflops = model_flops(cfg, shape)
    mext = model_flops_ext(cfg, shape)
    hlo_total = flops_dev * num_devices
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        wire_bytes_per_device=wires["total"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops_total=mflops, hlo_flops_total=hlo_total,
        useful_ratio=(mflops / hlo_total) if hlo_total else 0.0,
        collective_ops=int(wires["num_ops"]),
        model_flops_ext=mext,
        useful_ratio_ext=(mext / hlo_total) if hlo_total else 0.0,
    )
