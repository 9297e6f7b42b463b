"""Carry scenes and tiled states across from the JAX package as numpy.

The tests hand both packages identical inputs this way: the JAX side's
arrays are converted with ``numpy.asarray`` into a dict, and these
functions build the port's objects from that dict.  Nothing here imports
the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gsmpm_tpu_torch.models.gaussians import SCENE_FIELDS, GaussianScene
from gsmpm_tpu_torch.sim.state import MPMState
from gsmpm_tpu_torch.sim.tiles import TiledState

TILED_FIELDS = ("q", "aux", "material", "orig", "chunk_tile", "chunk_first",
                "chunk_live", "need_rebucket", "ok")


def scene_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> GaussianScene:
    """GaussianScene arrays (plus optional ``sh_degree``) -> port scene."""
    return GaussianScene(
        **{k: torch.from_numpy(np.array(d[k], np.float32)).to(device)
           for k in SCENE_FIELDS},
        sh_degree=int(d.get("sh_degree", 3)),
    )


def tiled_state_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> TiledState:
    """TiledState arrays -> port TiledState (int tables as int32, orig as
    int64, flags as 0-d bool)."""
    def t(k, dtype):
        return torch.from_numpy(np.array(d[k])).to(device=device, dtype=dtype)

    return TiledState(
        q=t("q", torch.float32), aux=t("aux", torch.float32),
        material=t("material", torch.int32), orig=t("orig", torch.int64),
        chunk_tile=t("chunk_tile", torch.int32),
        chunk_first=t("chunk_first", torch.int32),
        chunk_live=t("chunk_live", torch.int32),
        need_rebucket=t("need_rebucket", torch.bool),
        ok=t("ok", torch.bool),
    )


def state_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> MPMState:
    """MPMState arrays -> port MPMState (all float32)."""
    return MPMState(**{
        f: torch.from_numpy(np.array(d[f], np.float32)).to(device)
        for f in MPMState.__dataclass_fields__
    })
