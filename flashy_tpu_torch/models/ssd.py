"""SSD mixer (port of flashy_tpu/models/ssd.py): the state-space-duality
layer that drops in where Attention sits in a Block.

One fused projection produces, per head, the SSD triple plus a decay
logit:

    c [.., N]   what the output reads from the state
    b [.., N]   what the token writes into the state
    v [.., Dh]  the written value
    dt [.., 1]  decay logit; log a = -softplus(dt + dt_bias[h]) <= 0

so a layer's whole sequence-mixing memory is one [H, Dh, N] f32 state
per sequence. The uncached forward runs the chunked form
(`ops.ssd_scan.ssd_chunked_scan`, the Hopper kernel on CUDA); decoding
advances the recurrence (`models.decoding`). In training the scan's
backward differentiates the plain chunked form (`ops.ssd_scan.
SsdScanFunction`), and with dropout > 0 the block drops the mixer's
output as it drops attention's (`models.transformer.Block`). Leaves keep
the flax layouts: `cbv.kernel` [D, H, 2N+Dh+1], `dt_bias` [H] and
`out.kernel` [H, Dh, D].
"""
import typing as tp

import torch
from torch import nn

from ..ops.ssd_scan import SSD_LOG_RESET, ssd_chunked_scan
from .transformer import _Kernel


def ssd_log_decay(dt: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """Decay logits [..., H] + per-head bias [H] -> f32 log decays in
    (-inf, 0]. softplus is spelled `logaddexp(x, 0)`, as `jax.nn.softplus`
    is: torch's `softplus` turns into the identity above 20."""
    x = dt.float() + dt_bias.float()
    return -torch.logaddexp(x, torch.zeros_like(x))


def ssd_segment_log_decay(log_a: torch.Tensor,
                          segment_ids: tp.Optional[torch.Tensor]
                          ) -> tp.Tuple[torch.Tensor,
                                        tp.Optional[torch.Tensor]]:
    """Fold packed-batch segments into the decays: `SSD_LOG_RESET` at
    every segment start (t = 0 included) zeroes what the previous
    document left in the state; padding (segment id 0) gets token_mask
    False. Returns (log_a, token_mask or None)."""
    if segment_ids is None:
        return log_a, None
    start = torch.cat([
        torch.ones_like(segment_ids[:, :1], dtype=torch.bool),
        segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)      # [B, T]
    log_a = torch.where(start[:, :, None],
                        torch.full_like(log_a, SSD_LOG_RESET), log_a)
    return log_a, segment_ids > 0


def ssd_projections(cfg: tp.Any, normed: torch.Tensor, cbv: torch.Tensor,
                    dt_bias: torch.Tensor):
    """The fused projection split into (c, b, v, f32 log_a); `cbv` is
    the kernel already in the compute dtype."""
    nstate = cfg.ssd_state_dim
    proj = torch.einsum("btd,dhp->bthp", normed, cbv)
    c = proj[..., :nstate]                                  # [B, T, H, N]
    b = proj[..., nstate:2 * nstate]                        # [B, T, H, N]
    v = proj[..., 2 * nstate:2 * nstate + cfg.head_dim]     # [B, T, H, Dh]
    return c, b, v, ssd_log_decay(proj[..., -1], dt_bias)


class SSDMixer(nn.Module):
    def __init__(self, cfg: tp.Any, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        if cfg.ssd_state_dim <= 0:
            raise ValueError(
                "config.ssd_state_dim must be > 0 for SSD mixer layers")
        self.config = cfg
        h, dh = cfg.num_heads, cfg.head_dim
        self.cbv = _Kernel((cfg.dim, h, 2 * cfg.ssd_state_dim + dh + 1),
                           cfg.dim, generator, device)
        # decays start slow (a ~ 0.982): the state remembers at init
        self.dt_bias = nn.Parameter(torch.full((h,), -4.0, device=device))
        self.out = _Kernel((h, dh, cfg.dim), h * dh, generator, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: tp.Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg = self.config
        c, b, v, log_a = ssd_projections(
            cfg, x.to(cfg.dtype), self.cbv.kernel.to(cfg.dtype),
            self.dt_bias)
        log_a, token_mask = ssd_segment_log_decay(log_a, segment_ids)
        y, _ = ssd_chunked_scan(c, b, v, log_a,
                                chunk=cfg.ssd_chunk or None,
                                token_mask=token_mask, kernel=cfg.ssd_kernel)
        return torch.einsum("bthd,hdD->btD", y,
                            self.out.kernel.to(cfg.dtype))
