"""Wigner-D rotation matrices for real spherical harmonics, in torch.

eSCN/Equiformer-v2 rotate every edge's irrep features into a frame where the
edge direction is +z, apply SO(2)-block linear maps, and rotate back.  The
rotation on degree-l features is the Wigner matrix D^l.

We build D^l from the explicit little-d formula (Wigner 1931):

  d^l_{m',m}(b) = sqrt((l+m')!(l-m')!(l+m)!(l-m)!) *
      sum_k (-1)^k / ((l+m-k)! k! (l-k-m')! (m'-m+k)!) *
      cos(b/2)^(2l+m-m'-2k) * sin(b/2)^(m'-m+2k)

precomputed per l as flat (coef, cos-power, sin-power, position) term tables
(host numpy), evaluated per edge with one einsum -- no e3nn dependency.
Complex D^l_{m'm}(a,b,0) = exp(-i m' a) d^l_{m'm}(b) is converted to the real
basis with the standard unitary U_l.  Validated against direct rotation of
real spherical harmonics.  The reference's ``models/gnn/wigner.py``: the
numpy term tables are the port's own copies, and the complex arithmetic
stays complex64, on the CPU and on CUDA alike.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# little-d term tables
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _d_terms(l: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (coefs [T], cos_pow [T], sin_pow [T], flat_pos [T]) for d^l."""
    coefs: List[float] = []
    cpow: List[int] = []
    spow: List[int] = []
    pos: List[int] = []
    f = math.factorial
    for im_, mp in enumerate(range(-l, l + 1)):       # m' (row)
        for im, m in enumerate(range(-l, l + 1)):     # m  (col)
            pref = math.sqrt(f(l + mp) * f(l - mp) * f(l + m) * f(l - m))
            kmin = max(0, m - mp)
            kmax = min(l + m, l - mp)
            for k in range(kmin, kmax + 1):
                denom = f(l + m - k) * f(k) * f(l - k - mp) * f(mp - m + k)
                coefs.append(pref * ((-1) ** (mp - m + k)) / denom)
                cpow.append(2 * l + m - mp - 2 * k)
                spow.append(mp - m + 2 * k)
                pos.append(im_ * (2 * l + 1) + im)
    return (np.asarray(coefs, np.float64), np.asarray(cpow, np.int32),
            np.asarray(spow, np.int32), np.asarray(pos, np.int32))


@lru_cache(maxsize=None)
def _d_scatter(l: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Term table as (scatter [T, (2l+1)^2] coef matrix, cos_pow, sin_pow)."""
    coefs, cpow, spow, pos = _d_terms(l)
    t = len(coefs)
    scatter = np.zeros((t, (2 * l + 1) ** 2), np.float64)
    scatter[np.arange(t), pos] = coefs
    return scatter, cpow, spow


def little_d(l: int, beta: torch.Tensor) -> torch.Tensor:
    """d^l(beta): [..., 2l+1, 2l+1] (rows m', cols m)."""
    scatter, cpow, spow = _d_scatter(l)
    half = beta * 0.5
    c, s = torch.cos(half), torch.sin(half)
    maxp = 2 * l + 1
    # powers 0..2l
    c_p = torch.stack([c ** p for p in range(maxp)], dim=-1)
    s_p = torch.stack([s ** p for p in range(maxp)], dim=-1)
    dev = beta.device
    terms = (c_p[..., torch.from_numpy(cpow).long().to(dev)]
             * s_p[..., torch.from_numpy(spow).long().to(dev)])  # [..., T]
    flat = terms @ torch.from_numpy(scatter).to(terms.dtype).to(dev)
    return flat.reshape(tuple(beta.shape) + (2 * l + 1, 2 * l + 1))


# ---------------------------------------------------------------------------
# complex -> real basis unitary
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _real_unitary(l: int) -> np.ndarray:
    """U_l with Y_real = U_l @ Y_complex (rows: real m index -l..l)."""
    n = 2 * l + 1
    u = np.zeros((n, n), np.complex128)
    sq = 1.0 / math.sqrt(2.0)
    for m in range(-l, l + 1):
        row = m + l
        if m == 0:
            u[row, l] = 1.0
        elif m > 0:
            # Y_{l m}^real = ((-1)^m Y_m + Y_{-m}) / sqrt(2)
            u[row, l + m] = ((-1) ** m) * sq
            u[row, l - m] = sq
        else:
            # Y_{l -|m|}^real = ((-1)^m Y_{|m|} - Y_{-|m|}) * (1j/sqrt(2))... sign conv:
            am = -m
            u[row, l + am] = ((-1) ** am) * (1j * sq)
            u[row, l - am] = -1j * sq
    return u


def real_wigner_d(l: int, alpha: torch.Tensor, beta: torch.Tensor
                  ) -> torch.Tensor:
    """Real-basis D^l(alpha, beta, 0): [..., 2l+1, 2l+1].

    Acts on real-SH coefficient vectors: y(R r) = D @ y(r) where R is the
    ZY-Euler rotation (alpha about z then beta about y)."""
    d = little_d(l, beta).to(torch.complex64)
    ms = torch.arange(-l, l + 1, device=alpha.device).to(alpha.dtype)
    phase = torch.exp(-1j * (alpha[..., None] * ms))   # [..., 2l+1] rows m'
    dc = phase[..., :, None] * d                       # e^{-i m' a} d^l_{m'm}
    u = torch.from_numpy(_real_unitary(l)).to(torch.complex64).to(
        alpha.device)
    dr = torch.einsum("ij,...jk,kl->...il", u, dc, u.conj().T)
    return dr.real


def edge_rotation_angles(rhat: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euler angles (alpha, beta) of the rotation taking r̂ to +z.

    R = Ry(-beta) Rz(-alpha) with alpha = atan2(y, x), beta = acos(z).
    In SH-coefficient space this composes as D(0, -beta) @ D(-alpha, 0);
    equivalently we return (alpha, beta) and apply the inverse convention in
    `edge_wigner` below."""
    x, y, z = rhat[..., 0], rhat[..., 1], rhat[..., 2]
    alpha = torch.atan2(y, x)
    beta = torch.arccos(torch.clamp(z, -1.0, 1.0))
    return alpha, beta


def edge_wigner(l: int, rhat: torch.Tensor) -> torch.Tensor:
    """D^l rotating coefficients into the edge-aligned frame (r̂ -> +z).

    Composition: first undo the azimuth (rotate by -alpha about z), then tilt
    by -beta about y:  D = D(0, -beta) @ D(-alpha, 0)."""
    alpha, beta = edge_rotation_angles(rhat)
    zero = torch.zeros_like(alpha)
    d_az = real_wigner_d(l, -alpha, zero)
    d_tilt = real_wigner_d(l, zero, -beta)
    return torch.einsum("...ij,...jk->...ik", d_tilt, d_az)


# ---------------------------------------------------------------------------
# real spherical harmonics (for validation + edge embeddings)
# ---------------------------------------------------------------------------


def real_sph_harm(l_max: int, rhat: torch.Tensor) -> torch.Tensor:
    """Real SH values Y_{lm}(r̂) for l<=l_max: [..., (l_max+1)^2].

    Condon-Shortley-free convention matching `_real_unitary`."""
    x, y, z = rhat[..., 0], rhat[..., 1], rhat[..., 2]
    theta = torch.arccos(torch.clamp(z, -1.0, 1.0))
    phi = torch.atan2(y, x)
    ct = torch.cos(theta)
    st = torch.sin(theta)
    # associated Legendre P_l^m(ct) with CS phase INCLUDED (standard physics)
    p = {}
    p[(0, 0)] = torch.ones_like(ct)
    for m in range(1, l_max + 1):
        p[(m, m)] = (-1.0) * (2 * m - 1) * st * p[(m - 1, m - 1)]
    for m in range(0, l_max):
        p[(m + 1, m)] = (2 * m + 1) * ct * p[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            p[(l, m)] = ((2 * l - 1) * ct * p[(l - 1, m)]
                         - (l + m - 1) * p[(l - 2, m)]) / (l - m)
    out = []
    f = math.factorial
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * f(l - am) / f(l + am))
            if m == 0:
                out.append(norm * p[(l, 0)])
            elif m > 0:
                # remove CS phase to match the real-basis unitary
                out.append(math.sqrt(2.0) * norm * ((-1) ** am)
                           * p[(l, am)] * torch.cos(am * phi))
            else:
                out.append(math.sqrt(2.0) * norm * ((-1) ** am)
                           * p[(l, am)] * torch.sin(am * phi))
    return torch.stack(out, dim=-1)


def l_slices(l_max: int) -> List[slice]:
    out, off = [], 0
    for l in range(l_max + 1):
        out.append(slice(off, off + 2 * l + 1))
        off += 2 * l + 1
    return out
