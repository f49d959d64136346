"""Architecture registry + (arch × input-shape) cell logic.

SHAPES (assignment):
  train_4k     seq 4,096   global_batch 256   lowers train_step
  prefill_32k  seq 32,768  global_batch 32    lowers prefill (forward)
  decode_32k   seq 32,768  global_batch 128   lowers serve_step (1 token,
                                              KV cache depth = seq)
  long_500k    seq 524,288 global_batch 1     lowers serve_step; requires
                                              sub-quadratic context (SSM /
                                              hybrid only)

Cell skips (DESIGN.md §Arch-applicability):
  - long_500k skipped for pure full-attention archs (7 of 10)
  - encoder-only (hubert) has no decode: decode_32k + long_500k skipped
  ⇒ 31 valid cells.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen2-72b", "deepseek-7b", "granite-3-2b", "deepseek-67b",
    "jamba-1.5-large-398b", "qwen2-vl-7b", "qwen2-moe-a2.7b",
    "deepseek-v2-lite-16b", "hubert-xlarge", "mamba2-2.7b",
]

_MODULES = {
    "qwen2-72b": "qwen2_72b",
    "deepseek-7b": "deepseek_7b",
    "granite-3-2b": "granite_3_2b",
    "deepseek-67b": "deepseek_67b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-2.7b": "mamba2_2_7b",
}

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def _module(arch: str):
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE


def cell_step_kind(arch: str, shape: str) -> str:
    cfg = get_config(arch)
    kind = SHAPES[shape]["kind"]
    if cfg.kind == "encoder" and kind == "prefill":
        return "prefill"            # encoder forward
    return kind


def cell_valid(arch: str, shape: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    s = SHAPES[shape]
    if cfg.kind == "encoder" and s["kind"] == "decode":
        return False, "encoder-only: no decode step"
    if shape == "long_500k" and cfg.kind in ("decoder", "encoder"):
        return False, "pure full-attention arch: needs sub-quadratic context"
    return True, ""


def valid_cells():
    out = []
    for a in ARCHS:
        for s in SHAPES:
            ok, why = cell_valid(a, s)
            if ok:
                out.append((a, s))
    return out
