"""ITU-R P.2040-3 radio-material table as a differentiable ``nn.Module``.

The PyTorch counterpart of :mod:`hermespy_rt_tpu.materials`: the same 17
rows, each carrying the ITU power-law coefficients ``a, b, c, d`` for
relative permittivity and conductivity, the scattering coefficient ``s``, the
lobe ratios ``s1, s2, s3`` and the lobe widths ``s1_alpha, s3_alpha``.  Each
column is an ``nn.Parameter`` of shape ``[M]``, so ``loss.backward()``
reaches every coefficient the tracer reads.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

__all__ = [
    "MaterialTable",
    "MATERIAL_FIELDS",
    "MATERIAL_NAMES",
    "MATERIAL_KEYS",
    "NUM_MATERIALS",
    "default_materials",
    "get_material_index",
]

MATERIAL_AIR = 0
MATERIAL_CONCRETE = 1
MATERIAL_METAL = 13

NUM_MATERIALS = 17

MATERIAL_NAMES: List[str] = [
    "air", "concrete", "brick", "plasterboard", "wood", "glass", "glass",
    "ceiling board", "ceiling board", "chipboard", "plywood", "marble",
    "floorboard", "metal", "very dry ground", "medium dry ground", "wet ground",
]

MATERIAL_KEYS: Dict[str, int] = {
    "air": 0, "concrete": 1, "brick": 2, "plasterboard": 3, "wood": 4,
    "glass1": 5, "glass2": 6, "ceiling_board1": 7, "ceiling_board2": 8,
    "chipboard": 9, "plywood": 10, "marble": 11, "floorboard": 12,
    "metal": 13, "very_dry_ground": 14, "medium_dry_ground": 15,
    "wet_ground": 16,
}

MATERIAL_FIELDS = ("a", "b", "c", "d", "s", "s1", "s2", "s3", "s1_alpha",
                   "s3_alpha")

# ITU-R P.2040-3 Table 3 rows (a, b, c, d, s, s1, s2, s3, s1_alpha, s3_alpha),
# identical to the JAX package's table so path gains are bit-comparable.
_ITU_ROWS = [
    # a,      b,     c,         d,      s,    s1,   s2,   s3,  s1a, s3a
    (1.0,    0.0,   0.0,       0.001,  0.1,  0.5,  0.3,  0.2,  2,  2),   # air
    (5.24,   0.0,   0.0462,    0.7822, 0.5,  0.33, 0.34, 0.33, 4,  4),   # concrete
    (3.91,   0.0,   0.0238,    0.16,   0.4,  0.4,  0.3,  0.3,  3,  3),   # brick
    (2.73,   0.0,   0.0085,    0.9395, 0.3,  0.4,  0.4,  0.2,  3,  3),   # plasterboard
    (1.99,   0.0,   0.0047,    1.0718, 0.2,  0.5,  0.3,  0.2,  2,  2),   # wood
    (6.31,   0.0,   0.0036,    1.3394, 0.3,  0.4,  0.4,  0.2,  3,  3),   # glass (1)
    (5.79,   0.0,   0.0004,    1.658,  0.3,  0.4,  0.4,  0.2,  3,  3),   # glass (2)
    (1.48,   0.0,   0.0011,    1.0750, 0.2,  0.5,  0.3,  0.2,  2,  2),   # ceiling board (1)
    (1.52,   0.0,   0.0029,    1.029,  0.2,  0.5,  0.3,  0.2,  2,  2),   # ceiling board (2)
    (2.58,   0.0,   0.0217,    0.7800, 0.4,  0.4,  0.3,  0.3,  3,  3),   # chipboard
    (2.71,   0.0,   0.33,      0.0,    0.3,  0.5,  0.3,  0.2,  3,  3),   # plywood
    (7.074,  0.0,   0.0055,    0.9262, 0.3,  0.4,  0.4,  0.2,  3,  3),   # marble
    (3.66,   0.0,   0.0044,    1.3515, 0.3,  0.4,  0.4,  0.2,  3,  3),   # floorboard
    (1.0,    0.0,   1.0e7,     0.0,    0.0,  0.0,  1.0,  0.0,  1,  1),   # metal
    (3.0,    0.0,   0.00015,   2.52,   0.4,  0.3,  0.4,  0.3,  4,  4),   # very dry ground
    (15.0,  -0.1,   0.035,     1.63,   0.5,  0.33, 0.34, 0.33, 4,  4),   # medium dry ground
    (30.0,  -0.4,   0.15,      1.30,   0.5,  0.33, 0.34, 0.33, 4,  4),   # wet ground
]


class MaterialTable(nn.Module):
    """Dense, differentiable material table: ten f32 ``[M]`` parameters
    indexed by material id (``eps' = a f^b``, ``sigma = c f^d``, f in GHz)."""

    def __init__(self, columns: Dict[str, object], device="cuda"):
        super().__init__()
        for f in MATERIAL_FIELDS:
            t = torch.as_tensor(np.array(columns[f], np.float32),
                                device=device)
            self.register_parameter(f, nn.Parameter(t))

    @property
    def num_materials(self) -> int:
        return self.a.shape[0]


def default_materials(device="cuda") -> MaterialTable:
    """The 17-row ITU-R P.2040-3 table used by the reference tracer."""
    rows = np.asarray(_ITU_ROWS, dtype=np.float32)
    return MaterialTable({f: rows[:, i] for i, f in enumerate(MATERIAL_FIELDS)},
                         device=device)


def get_material_index(name: str) -> int:
    """Material id for ``name``; unknown names map to air (id 0), as in the
    reference."""
    return MATERIAL_KEYS.get(name, MATERIAL_AIR)
