"""Differentially private federated averaging under secure aggregation.

Counterpart of `hefl_tpu.fl.dp`: DP-FedAvg with the noise distributed over
the clients, before encryption.

  1. each client computes its delta against the round's global weights,
  2. clips it to L2 norm `clip_norm` (the mechanism's sensitivity),
  3. adds Gaussian noise N(0, (noise_multiplier * clip_norm / sqrt(K))^2)
     per coordinate, and encrypts the result (fl/secure.py);
  4. the K shares sum under the encrypted aggregation to the central
     Gaussian mechanism's N(0, (noise_multiplier * clip_norm)^2) on the sum
     of clipped deltas, which `epsilon_spent` accounts.

Partial participation: an excluded client takes its share with it, so
`DpConfig.min_surviving` declares a floor k and every share is calibrated to
sigma*C/sqrt(k) (conservative over-noising: any s >= k survivors carry at
least the central noise). A round surviving below the floor fails loudly in
`fl.secure`. The accountant (`epsilon_spent`, Renyi DP, with amplification
by subsampling for sampled cohorts) is plain Python `math`, the JAX
package's code: the two agree exactly.

`dp_sanitize` is split like the port's samplers: `dp_sanitize_core` takes
the standard-normal noise tensors, and `dp_sanitize` draws them from the
client's DP generator, leaf by leaf in the packing order
(`convert.ravel_order`), so a test can feed the core the JAX package's
draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hefl_tpu_torch.convert import ravel_order, torch_name


@dataclasses.dataclass(frozen=True)
class DpConfig:
    """clip_norm: L2 bound C on one client's delta. noise_multiplier: sigma
    of the central mechanism in units of C. delta: target delta of
    `epsilon_spent`. min_surviving: the noise floor k (0 = the
    full-participation calibration, under which any exclusion fails
    loudly; the driver derives one from the fault schedule when faults are
    on and none is set)."""

    clip_norm: float = 1.0
    noise_multiplier: float = 1.0
    delta: float = 1e-5
    min_surviving: int = 0

    def __post_init__(self):
        if self.min_surviving < 0:
            raise ValueError(
                f"DpConfig.min_surviving={self.min_surviving}: must be >= 0 "
                "(0 = full-participation calibration)"
            )


def calibration_clients(dp: DpConfig, num_clients: int) -> int:
    """K_cal: the count under the sqrt of each share sigma*C/sqrt(K_cal), and
    the surviving-count floor below which a round must fail loudly."""
    if dp.min_surviving <= 0:
        return int(num_clients)
    return min(int(dp.min_surviving), int(num_clients))


def _leaf_names(params: dict) -> list[str]:
    """The parameter names in the packing order (the JAX tree's leaves)."""
    return [torch_name(layer, leaf) for layer, leaf in ravel_order(params)]


def global_l2_norm(params: dict) -> torch.Tensor:
    """L2 norm over every leaf, one float32 scalar (squares summed in
    float32, leaf by leaf in the packing order)."""
    sq = sum(torch.sum(torch.square(params[k].to(torch.float32))) for k in _leaf_names(params))
    return torch.sqrt(sq)


def clip_by_global_norm(params: dict, clip_norm: float) -> tuple[dict, torch.Tensor]:
    """Scale every leaf by min(1, clip_norm / ||params||) (never amplifies)
    -> (clipped, pre-clip norm)."""
    norm = global_l2_norm(params)
    clip = torch.tensor(np.float32(clip_norm), device=norm.device)
    factor = torch.minimum(torch.ones((), device=norm.device),
                           clip / torch.clamp(norm, min=1e-12))
    return {k: v * factor for k, v in params.items()}, norm


def dp_sanitize_core(global_params: dict, trained_params: dict, dp: DpConfig,
                     num_clients: int, noise: dict) -> tuple[dict, torch.Tensor]:
    """One client's DP step on given noise: `noise[name]` a float32 standard
    normal tensor of each leaf's shape. -> (global + clip(delta) +
    share * noise, pre-clip norm), share = sigma*C/sqrt(num_clients).

    The noise is added in float32 and the SUM cast back to the leaf's dtype
    (the JAX order): casting the noise alone would round shares below the
    leaf's ulp to zero and void the accounted guarantee."""
    delta = {k: trained_params[k] - global_params[k] for k in trained_params}
    clipped, norm = clip_by_global_norm(delta, dp.clip_norm)
    share = np.float32(dp.noise_multiplier * dp.clip_norm / math.sqrt(num_clients))
    out = {}
    for k, x in clipped.items():
        s = torch.tensor(share, device=x.device)
        noised = (x.to(torch.float32) + s * noise[k].to(torch.float32)).to(x.dtype)
        out[k] = global_params[k] + noised
    return out, norm


def dp_sanitize(gen: torch.Generator, global_params: dict, trained_params: dict, dp: DpConfig,
                num_clients: int) -> tuple[dict, torch.Tensor]:
    """One client's DP step: clip its delta, add its distributed noise share,
    standard-normal float32 noise drawn from `gen` (on its device) leaf by
    leaf in the packing order. -> (sanitized params, pre-clip norm)."""
    noise = {k: torch.randn(trained_params[k].shape, generator=gen, device=gen.device,
                            dtype=torch.float32).to(trained_params[k].device)
             for k in _leaf_names(trained_params)}
    return dp_sanitize_core(global_params, trained_params, dp, num_clients, noise)


def _subsampled_gaussian_rdp(q: float, sigma: float, alpha: int) -> float:
    """RDP(alpha) of one Poisson-subsampled Gaussian mechanism at rate q:
    the integer-alpha binomial-expansion upper bound

        (1/(a-1)) * log( sum_j C(a,j) (1-q)^(a-j) q^j e^{j(j-1)/(2 sigma^2)} )

    in log space (lgamma + log-sum-exp)."""
    lq, l1q = math.log(q), math.log1p(-q)
    terms = []
    for j in range(alpha + 1):
        lc = math.lgamma(alpha + 1) - math.lgamma(j + 1) - math.lgamma(alpha - j + 1)
        terms.append(lc + (alpha - j) * l1q + j * lq + j * (j - 1) / (2.0 * sigma**2))
    m = max(terms)
    lse = m + math.log(sum(math.exp(t - m) for t in terms))
    return lse / (alpha - 1)


def _rdp_epsilon(rounds: int, noise_multiplier: float, delta: float) -> float:
    """Renyi accounting of `rounds` composed (unsampled) Gaussian
    mechanisms, optimized over an alpha grid."""
    best = float("inf")
    alphas = [1.0 + x / 10.0 for x in range(1, 400)] + list(range(41, 512))
    for a in alphas:
        rdp = rounds * a / (2.0 * noise_multiplier**2)
        eps = rdp + math.log(1.0 / delta) / (a - 1.0)
        best = min(best, eps)
    return best


def epsilon_spent(rounds: int, noise_multiplier: float, delta: float = 1e-5,
                  sample_rate: float = 1.0) -> float:
    """(epsilon, delta)-DP spent after `rounds` rounds: the unsampled Renyi
    bound at sample_rate 1, and at q < 1 the tighter of it and the
    subsampled Gaussian's RDP composed over rounds (integer alphas)."""
    if noise_multiplier <= 0:
        return float("inf")
    if rounds <= 0:
        return 0.0
    if not 0.0 <= sample_rate <= 1.0:
        raise ValueError(f"sample_rate={sample_rate}: must be in [0, 1]")
    full = _rdp_epsilon(rounds, noise_multiplier, delta)
    if sample_rate >= 1.0:
        return full
    if sample_rate == 0.0:
        return 0.0
    q = float(sample_rate)
    best = full
    for a in range(2, 257):
        rdp_a = _subsampled_gaussian_rdp(q, noise_multiplier, a)
        best = min(best, rounds * rdp_a + math.log(1.0 / delta) / (a - 1))
    return best
