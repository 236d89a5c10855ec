"""MACE-style E(3)-equivariant message passing (l_max=2, correlation 3).

Higher-order equivariant message passing per MACE (arXiv:2206.07697):
radial Bessel basis, spherical-harmonic edge attributes up to l=2,
many-body product basis of correlation order 3, two interaction layers.

The JAX package's exactly equivariant subset of the Clebsch-Gordan
product basis, unchanged: scalar x tensor couplings (CG = identity), the
l=1 x l=1 -> l=1 cross product, and per-l inner products for invariants,
each a dense channelwise product.  JAX's functional updates
(``.at[...].set`` / ``.add``) become concatenations, so autograd sees no
in-place write.

Feature layout: [N, 9, C] with components [l0 | l1(x,y,z) | l2(5)] in the
orthonormal real spherical-harmonic basis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..kernels import gather_index, gather_rows
from .common import _ParamTree, normal_init, segment_sum

PyTree = Any

_L_SLICES = {0: slice(0, 1), 1: slice(1, 4), 2: slice(4, 9)}


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    n_species: int = 10
    r_cut: float = 5.0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32


def real_sph_harm_l2(rhat):
    """rhat [E,3] unit vectors -> [E,9] orthonormal real SH (l<=2)."""
    x, y, z = rhat[:, 0], rhat[:, 1], rhat[:, 2]
    c0 = 0.28209479177387814
    c1 = 0.4886025119029199
    c2a = 1.0925484305920792
    c2b = 0.31539156525252005
    c2c = 0.5462742152960396
    return torch.stack(
        [
            torch.full_like(x, c0),
            c1 * x, c1 * y, c1 * z,
            c2a * x * y,
            c2a * y * z,
            c2b * (3 * z * z - 1.0),
            c2a * x * z,
            c2c * (x * x - y * y),
        ],
        dim=-1,
    )


def bessel_rbf(d, n_rbf: int, r_cut: float):
    """Radial Bessel basis with smooth cutoff; d [E] -> [E, n_rbf]."""
    d = torch.clamp(d, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    rb = math.sqrt(2.0 / r_cut) * torch.sin(
        n[None, :] * math.pi * d[:, None] / r_cut
    ) / d[:, None]
    # polynomial cutoff envelope
    u = torch.clamp(d / r_cut, 0.0, 1.0)
    env = 1.0 - 10.0 * u**3 + 15.0 * u**4 - 6.0 * u**5
    return rb * env[:, None]


def _cross(a, b):
    """l1 x l1 -> l1 (exact CG coupling up to scale); [.. ,3,C]."""
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-2
    )


def product_basis(A):
    """A [N, 9, C] -> (equivariant features [N, 9, C*3],
    invariants [N, C*5]).  Correlation order up to 3 via exact couplings:
    nu=1: A;  nu=2: A0*A, A1 x A1, per-l dots;  nu=3: (A.A)*A, A0^2*A."""
    A0 = A[:, _L_SLICES[0], :]          # [N,1,C]
    A1 = A[:, _L_SLICES[1], :]          # [N,3,C]
    dots = torch.cat(
        [torch.sum(A[:, s, :] ** 2, dim=1) for s in _L_SLICES.values()],
        dim=-1,
    )  # [N, 3C] invariants (nu=2)
    norm2 = torch.sum(A * A, dim=1, keepdim=True)  # [N,1,C] invariant
    eq2 = A0 * A                        # scalar x tensor  (nu=2)
    eq3 = norm2 * A                     # invariant x tensor (nu=3)
    cross = _cross(A1, eq2[:, _L_SLICES[1], :])  # nu=3, l=1 block
    # eq3.at[:, 1:4, :].add(cross)
    eq3 = torch.cat([eq3[:, _L_SLICES[0], :],
                     eq3[:, _L_SLICES[1], :] + cross,
                     eq3[:, _L_SLICES[2], :]], dim=1)
    feats = torch.cat([A, eq2, eq3], dim=-1)  # [N,9,3C]
    inv3 = (A0[:, 0, :] ** 2) * A0[:, 0, :]
    invs = torch.cat([dots, norm2[:, 0, :], inv3], dim=-1)
    return feats, invs


def _build(cfg: MACEConfig, w) -> PyTree:
    C = cfg.d_hidden
    params: Dict[str, Any] = {
        "embed": w((cfg.n_species, C), 1.0),
        "layers": [],
        "readout_w1": w((C, C), C ** -0.5),
        "readout_w2": w((C, 1), C ** -0.5),
        # invariant (many-body) readout: 5C invariants per layer
        "readout_inv": w((cfg.n_layers * 5 * C, 1), (5 * C) ** -0.5),
    }
    for _ in range(cfg.n_layers):
        params["layers"].append(
            {
                # radial MLP: n_rbf -> C (per-channel edge weights)
                "r1": w((cfg.n_rbf, C), cfg.n_rbf ** -0.5),
                "r2": w((C, C), C ** -0.5),
                # channel mixing of the product basis (per l, shared)
                "mix": w((3 * C, C), (3 * C) ** -0.5),
                "self": w((C, C), C ** -0.5),
            }
        )
    return params


def init_params(gen: torch.Generator, cfg: MACEConfig,
                device=None) -> PyTree:
    """The JAX tree drawn from ``gen`` and placed on ``device`` (default:
    the generator's)."""
    device = device or gen.device
    return _build(cfg, lambda shape, std: normal_init(
        gen, shape, std, cfg.param_dtype, device))


def abstract_params(cfg: MACEConfig) -> PyTree:
    """The same tree on the ``meta`` device (``jax.eval_shape``)."""
    return _build(cfg, lambda shape, std: torch.empty(
        shape, dtype=cfg.param_dtype, device="meta"))


def forward(params, batch, cfg: MACEConfig):
    """batch: species [N], pos [N,3], edges [2,E], graph_id [N],
    n_graphs int, optional edge_mask [E].  Returns per-graph energy [G]."""
    species = batch["species"]
    pos = batch["pos"].to(cfg.compute_dtype)
    n = species.shape[0]
    # gathers clamp as JAX's indexing does; the segment sums drop
    src_g = gather_index(batch["edges"][0], n)
    dst = batch["edges"][1]
    dst_g = gather_index(dst, n)
    emask = batch.get("edge_mask")

    h = gather_rows(params["embed"], species)  # [N, C] scalars
    C = h.shape[-1]
    # lift to [N, 9, C]: zeros.at[:, 0, :].set(h)
    H = torch.cat([h[:, None, :], h.new_zeros((n, 8, C))], dim=1)

    rvec = pos.index_select(0, dst_g) - pos.index_select(0, src_g)
    # as JAX: 1e-12 is added to each component, not to the norm
    d = torch.linalg.norm(rvec + 1e-12, dim=-1)
    rhat = rvec / torch.clamp(d, min=1e-6)[:, None]
    Y = real_sph_harm_l2(rhat)          # [E, 9]
    rbf = bessel_rbf(d, cfg.n_rbf, cfg.r_cut)  # [E, n_rbf]
    # degenerate (zero-length / self-loop) edges carry no geometric
    # information and their SH values are basis artifacts (e.g. Y20(0) =
    # -c): masking them is required for exact E(3) equivariance.
    ok = (d > 1e-6).to(Y.dtype)
    Y = Y * ok[:, None]
    if emask is not None:
        Y = Y * emask[:, None]
        rbf = rbf * emask[:, None]

    all_invs = []
    for lp in params["layers"]:
        R = F.silu(rbf @ lp["r1"]) @ lp["r2"]  # [E, C]
        # messages: R_c * Y_lm * h_src[0,c] + R_c * Y_l0m0 * H_src[lm,c]
        Hs = H.index_select(0, src_g)
        msg = (
            R[:, None, :] * Y[:, :, None] * Hs[:, 0:1, :]
            + R[:, None, :] * Hs * Y[:, 0:1, None]
        )  # [E, 9, C]
        A = segment_sum(msg, dst, n)  # [N,9,C]
        feats, invs = product_basis(A)
        H = torch.einsum("nlk,kc->nlc", feats, lp["mix"])
        H = H + torch.einsum("nlc,cd->nld", A, lp["self"])
        all_invs.append(invs)
    # readout: scalar channels + many-body invariants
    scal = H[:, 0, :]
    e_node = F.silu(scal @ params["readout_w1"]) @ params["readout_w2"]
    e_node = e_node + torch.cat(all_invs, -1) @ params["readout_inv"]
    return segment_sum(e_node[:, 0], batch["graph_id"], batch["n_graphs"])


def energy_loss(params, batch, cfg: MACEConfig):
    e = forward(params, batch, cfg)
    return torch.mean((e - batch["targets"]) ** 2)


class MACE(_ParamTree):
    """MACE as an ``nn.Module`` whose parameter names are the tree's
    paths (``layers.0.mix``); its methods call the functions above on
    ``tree()``."""

    def __init__(self, cfg: MACEConfig, params: PyTree):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, batch):
        return forward(self.tree(), batch, self.cfg)

    def loss(self, batch):
        return energy_loss(self.tree(), batch, self.cfg)
