"""The input-shape cells and per-(arch, shape) input specs (counterpart of
``repro/launch/shapes.py``).

Shapes (brief):
    train_4k     seq 4096   global_batch 256   -> train_step
    prefill_32k  seq 32768  global_batch 32    -> prefill_step
    decode_32k   seq 32768  global_batch 128   -> serve_step (1 new token)
    long_500k    seq 524288 global_batch 1     -> serve_step; sub-quadratic
                                                  archs only

``input_specs`` returns meta tensors of every model input's shape and type
(the JAX package's ``ShapeDtypeStruct`` stand-ins): no memory, no numbers.
Modality frontends are stubs: audio supplies (B, 1500, d) frame
embeddings, vlm (B, 256, d) patch embeddings (patch positions replace the
leading text positions so the total sequence length matches the cell).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig

__all__ = ["SHAPES", "ShapeCell", "CELLS", "cell_applicable", "input_specs"]

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape == "long_500k" and not cfg.sub_quadratic():
        return False, ("pure full-attention arch: 524k-token decode needs a "
                       "full-length cache fed by an O(L^2) prefill — brief "
                       "directs running long_500k only for sub-quadratic "
                       "families")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Model inputs for the cell as meta tensors (excluding params / cache,
    which come from ``Model.shapes`` and ``init_cache`` on the meta
    device)."""
    cell = CELLS[shape]
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        # one new token against a cache of seq_len (the cache is built by
        # the dry-run)
        return {"tokens": _meta((b, 1), torch.int32)}
    text = s - cfg.n_patches
    d = {"tokens": _meta((b, text), torch.int32)}
    if cell.kind == "train":
        d["labels"] = _meta((b, text), torch.int32)
    if cfg.n_frames:
        d["frames"] = _meta((b, cfg.n_frames, cfg.d_model), torch.bfloat16)
    if cfg.n_patches:
        d["patches"] = _meta((b, cfg.n_patches, cfg.d_model), torch.bfloat16)
    return d
