"""BMFR denoiser, Blockwise Multi-Order Feature Regression; the torch
counterpart of tauray_tpu.stages.bmfr (reference: src/bmfr_stage.cc +
shader/bmfr_preprocess.comp, bmfr_fit.comp, bmfr_weighted_sum.comp,
bmfr_accumulate_output.comp; after Koskela et al. 2019).

Per 32x32 block, noisy (demodulated) radiance is least-squares fitted
against a feature basis {1, n.xyz, p.xyz, p.xyz^2} and replaced by the
fit, then accumulated over time along motion vectors. The fit is one
batched solve of every block's ridge-regularised normal equations
(torch.linalg.solve)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..ops.sampling import xla_int32

BLOCK = 32
NOISE_EPS = 1e-2


class BMFRState(NamedTuple):
    history: torch.Tensor      # (H, W, 6)
    history_len: torch.Tensor  # (H, W)
    normal: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def zeros(H, W, device) -> "BMFRState":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return BMFRState(history=z(H, W, 6), history_len=z(H, W),
                         normal=z(H, W, 3), pos=z(H, W, 3))

    @staticmethod
    def from_numpy(fields: Dict[str, Any], device) -> "BMFRState":
        """From a {field: numpy array} dict with this class's field names
        (for example tauray_tpu's BMFRState fields via np.asarray)."""
        return BMFRState(**{k: torch.from_numpy(np.array(
            fields[k], np.float32)).to(device) for k in BMFRState._fields})


def _blockify(img, H, W):
    C = img.shape[-1]
    return (img.reshape(H // BLOCK, BLOCK, W // BLOCK, BLOCK, C)
            .permute(0, 2, 1, 3, 4).reshape(-1, BLOCK * BLOCK, C))


def _unblockify(blocks, H, W):
    C = blocks.shape[-1]
    return (blocks.reshape(H // BLOCK, W // BLOCK, BLOCK, BLOCK, C)
            .permute(0, 2, 1, 3, 4).reshape(H, W, C))


def _pad_edge(img, Hp, Wp):
    """(H, W, C) -> (Hp, Wp, C), repeating the last row and column."""
    H, W = img.shape[:2]
    ys = torch.arange(Hp, device=img.device).clamp(max=H - 1)
    xs = torch.arange(Wp, device=img.device).clamp(max=W - 1)
    return img[ys][:, xs]


def _fit_blocks(noisy, normal, pos):
    """noisy: (H, W, C) -> its regression fit per 32x32 block."""
    H, W = noisy.shape[:2]
    Hp, Wp = H + (-H) % BLOCK, W + (-W) % BLOCK
    if (Hp, Wp) != (H, W):
        noisy, normal, pos = (_pad_edge(x, Hp, Wp)
                              for x in (noisy, normal, pos))
    y = _blockify(noisy, Hp, Wp)                        # (B, N, C)
    n = _blockify(normal, Hp, Wp)
    p = _blockify(pos, Hp, Wp)
    # normalise world positions per block (reference: bmfr_preprocess.comp)
    pmin = p.amin(dim=1, keepdim=True)
    pmax = p.amax(dim=1, keepdim=True)
    pn = (p - pmin) / torch.clamp(pmax - pmin, min=1e-3)
    ones = torch.ones(y.shape[:2] + (1,), dtype=torch.float32,
                      device=y.device)
    X = torch.cat([ones, n, pn, pn * pn], dim=-1)      # (B, N, 10)
    Xt = X.transpose(1, 2)
    A = Xt @ X + NOISE_EPS * torch.eye(X.shape[-1], device=X.device)
    b = Xt @ y
    coef = torch.linalg.solve(A, b)                     # (B, 10, C)
    fit = torch.clamp(X @ coef, min=0.0)
    return _unblockify(fit, Hp, Wp)[:H, :W]


def _reproject_history(state: BMFRState, motion, normal, pos):
    """Nearest-pixel history fetch with validity tests."""
    H, W = motion.shape[:2]
    mx = motion[..., 0] * W - 0.5
    my = (1.0 - motion[..., 1]) * H - 0.5
    x = xla_int32(torch.round(mx)).clamp(0, W - 1).long()
    y = xla_int32(torch.round(my)).clamp(0, H - 1).long()
    ph = state.history[y, x]
    pl = state.history_len[y, x]
    pn = state.normal[y, x]
    pp = state.pos[y, x]
    dp = pos - pp
    ok = ((pn * normal).sum(-1) > 0.9) & ((dp * dp).sum(-1) < 0.02)
    return ph, torch.where(ok, pl, 0.0), ok


def bmfr_denoise(state: BMFRState, diffuse, specular, motion, normal, pos,
                 albedo):
    """Returns (diffuse, specular, new state)."""
    cur = torch.cat([diffuse[..., :3], specular[..., :3]], dim=-1)
    fit = _fit_blocks(cur, normal, pos)
    ph, plen, ok = _reproject_history(state, motion, normal, pos)
    hist = plen + 1.0
    alpha = torch.clamp(1.0 / hist, min=0.05)[..., None]
    acc = torch.where(ok[..., None], ph * (1 - alpha) + fit * alpha, fit)
    new_state = BMFRState(history=acc, history_len=hist, normal=normal,
                          pos=pos)
    return acc[..., :3], acc[..., 3:], new_state
