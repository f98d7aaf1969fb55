"""Packed secret sharing (PSS) as batched linear maps -- field path.

Mirrors the JAX package's ``pss/pss.py`` (itself the reference's
``PackedSharingParams``):

* n = 8l parties, threshold t = l-1;
* ``share`` domain: size n, no coset offset;
* ``secret`` domain: size 2l, coset of F.GENERATOR;
* ``secret2`` domain: size 4l, coset of F.GENERATOR;
* ``pack_from_public`` = share.fft(secret.ifft(secrets));
* ``unpack``           = secret.fft(share.ifft(shares))[:l];
* ``unpack2``          = secret2.fft(share.ifft(shares))[0:2l:2];
* ``pack_single``      = pack_from_public(share.fft(secret.ifft([s]))),
  including the arkworks resize-truncation in the second ifft.

Every op is linear, so each is also exposed as a host-built matrix over
Python ints (``*_matrix``); ``convert.check_pss_matrices`` holds them to
the JAX package's.  The G1 methods apply the same maps to points
(``Curve.linear_map``); the G2 methods apply them to host G2 affine
points (``host_curve.g2_linear_map``): G2 lives only on the SRS and
verifier side.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..curves.host_curve import g2_linear_map
from ..fields.fr import Field
from ..ntt.ntt import Domain, intt, ntt


def _dft_matrix(p: int, size: int, offset: int, g: int) -> np.ndarray:
    """V[i, j] = (offset * g^i)^j  -- evaluation matrix (object ints)."""
    V = np.empty((size, size), dtype=object)
    for i in range(size):
        x = offset * pow(g, i, p) % p
        acc = 1
        for j in range(size):
            V[i, j] = acc
            acc = acc * x % p
    return V


def _idft_matrix(p: int, size: int, offset: int, g: int) -> np.ndarray:
    """Vinv[j, i] = offset^{-j} g^{-ij} / size -- interpolation matrix."""
    ninv = pow(size, -1, p)
    ginv = pow(g, -1, p)
    oinv = pow(offset, -1, p)
    M = np.empty((size, size), dtype=object)
    for j in range(size):
        scale = pow(oinv, j, p) * ninv % p
        for i in range(size):
            M[j, i] = scale * pow(ginv, i * j, p) % p
    return M


def _matmul_mod(A: np.ndarray, B: np.ndarray, p: int) -> np.ndarray:
    out = np.empty((A.shape[0], B.shape[1]), dtype=object)
    for i in range(A.shape[0]):
        for j in range(B.shape[1]):
            out[i, j] = sum(A[i, k] * B[k, j] for k in range(A.shape[1])) % p
    return out


class PackedSharingParams:
    """PSS parameters for one field and packing factor l (n = 8l parties)."""

    def __init__(self, field: Field, l: int):
        if l < 1 or l & (l - 1):
            raise ValueError(f"packing factor {l} is not a power of two")
        self.field = field
        self.l = l
        self.t = l - 1
        self.n = 8 * l
        name = field.spec.name
        gen = field.spec.generator
        self.dom_share = Domain(name, self.n, 1)
        self.dom_secret = Domain(name, 2 * l, gen)
        self.dom_secret2 = Domain(name, 4 * l, gen)

    def __hash__(self):
        return hash((self.field, self.l))

    def __eq__(self, other):
        return (
            isinstance(other, PackedSharingParams)
            and self.field == other.field
            and self.l == other.l
        )

    # ------------------------------------------------------------------
    # Field-element path (batched over leading dims; element axis = -2)
    # ------------------------------------------------------------------
    def pack_from_public(self, secrets: torch.Tensor) -> torch.Tensor:
        """[..., l, L] secrets -> [..., n, L] shares (deterministic)."""
        coeffs = intt(self.field, self.dom_secret, secrets)
        return ntt(self.field, self.dom_share, coeffs)

    def pack_from_public_rand(self, secrets: torch.Tensor, seed: int) -> torch.Tensor:
        """Append t+1 random evaluation points before packing."""
        rand = self.field.random(secrets.shape[:-2] + (self.t + 1,), seed)
        ext = torch.cat([secrets, rand], dim=-2)
        coeffs = intt(self.field, self.dom_secret, ext)
        return ntt(self.field, self.dom_share, coeffs)

    def unpack(self, shares: torch.Tensor) -> torch.Tensor:
        """[..., n, L] degree-(t+l) shares -> [..., l, L] secrets."""
        coeffs = intt(self.field, self.dom_share, shares)
        evals = ntt(self.field, self.dom_secret, coeffs)
        return evals[..., : self.l, :]

    def unpack2(self, shares: torch.Tensor) -> torch.Tensor:
        """[..., n, L] degree-2(t+l) shares -> [..., l, L] secrets."""
        coeffs = intt(self.field, self.dom_share, shares)
        evals = ntt(self.field, self.dom_secret2, coeffs)
        return evals[..., 0 : 2 * self.l : 2, :]

    def pack_single(self, secret: torch.Tensor) -> torch.Tensor:
        """[..., L] one secret -> [..., n, L] regular shares, with the
        reference's double application of the packing transform."""
        coeffs = intt(self.field, self.dom_secret, secret[..., None, :])
        mid = ntt(self.field, self.dom_share, coeffs)  # [., n, L]
        return self.pack_from_public(mid)  # intt truncates mid to 2l

    def pack_single_reconstructible(self, secret: torch.Tensor) -> torch.Tensor:
        """[..., L] one secret -> [..., n, L] shares that ``unpack`` to
        [s, 0, ..., 0] (the single transform; the JAX package's documented
        deviation, which pss2ss uses)."""
        coeffs = intt(self.field, self.dom_secret, secret[..., None, :])
        return ntt(self.field, self.dom_share, coeffs)

    def pack_single_reconstructible_vector(self) -> np.ndarray:
        """[n] object-int vector u: shares_j = u_j * secret (single transform)."""
        p = self.field.p
        spec = self.field.spec
        g_share = spec.root_of_unity(self.n) if self.n > 1 else 1
        V_share = _dft_matrix(p, self.n, 1, g_share)
        Vi_sec = _idft_matrix(p, 2 * self.l, spec.generator, spec.root_of_unity(2 * self.l))
        return _matmul_mod(V_share[:, : 2 * self.l], Vi_sec[:, :1], p)[:, 0]

    # ------------------------------------------------------------------
    # Host-side exact linear maps (object-int matrices, cached)
    # ------------------------------------------------------------------
    @functools.cached_property
    def _mats(self):
        p = self.field.p
        l, n = self.l, self.n
        spec = self.field.spec
        g_share = spec.root_of_unity(n) if n > 1 else 1
        g_sec = spec.root_of_unity(2 * l)
        g_sec2 = spec.root_of_unity(4 * l)
        off = spec.generator

        V_share = _dft_matrix(p, n, 1, g_share)
        Vi_share = _idft_matrix(p, n, 1, g_share)
        V_sec = _dft_matrix(p, 2 * l, off, g_sec)
        Vi_sec = _idft_matrix(p, 2 * l, off, g_sec)
        V_sec2 = _dft_matrix(p, 4 * l, off, g_sec2)

        pack = _matmul_mod(V_share[:, : 2 * l], Vi_sec[:, :l], p)  # [n, l]
        unpack = _matmul_mod(V_sec[:l, :], Vi_share[: 2 * l, :], p)  # [l, n]
        unpack2 = _matmul_mod(V_sec2[0 : 2 * l : 2, :], Vi_share[: 4 * l, :], p)  # [l, n]
        first = _matmul_mod(V_share[:, : 2 * l], Vi_sec[:, :1], p)  # [n, 1]
        psingle = _matmul_mod(_matmul_mod(V_share[:, : 2 * l], Vi_sec, p), first[: 2 * l, :], p)
        return {
            "pack": pack,
            "unpack": unpack,
            "unpack2": unpack2,
            "pack_single": psingle[:, 0],
        }

    def pack_matrix(self) -> np.ndarray:
        """[n, l] object-int matrix: shares = pack @ secrets."""
        return self._mats["pack"]

    def unpack_matrix(self) -> np.ndarray:
        return self._mats["unpack"]

    def unpack2_matrix(self) -> np.ndarray:
        return self._mats["unpack2"]

    def pack_single_vector(self) -> np.ndarray:
        """[n] object-int vector u: shares_j = u_j * secret."""
        return self._mats["pack_single"]

    # ------------------------------------------------------------------
    # Group-element path (G1 points; see curves/g1.py)
    # ------------------------------------------------------------------
    def pack_from_public_group(self, curve, secrets):
        """[..., l] points -> [..., n] share points: the field path's
        linear map, as a fixed-scalar combination per output share."""
        return curve.linear_map(self.pack_matrix(), secrets)

    def unpack_group(self, curve, shares):
        return curve.linear_map(self.unpack_matrix(), shares)

    def unpack2_group(self, curve, shares):
        return curve.linear_map(self.unpack2_matrix(), shares)

    # ------------------------------------------------------------------
    # G2 path (host-int affine points; the reference's DomainCoeff
    # genericity over G2, pss.rs:69)
    # ------------------------------------------------------------------
    def pack_from_public_g2(self, pts):
        """[l] host G2 affine points -> [n] share points."""
        return g2_linear_map(self.pack_matrix(), pts)

    def unpack_g2(self, shares):
        return g2_linear_map(self.unpack_matrix(), shares)

    def unpack2_g2(self, shares):
        return g2_linear_map(self.unpack2_matrix(), shares)
