"""blend_mat / mask_mat resolution (port of libyafaray_tpu/materials/
blend.py).

A blend material delegates every BSDF call to its two children with
interpolated weights; a mask material switches between them by its mask
value against a threshold.  Over the wavefront:
  eval / pdf / emission  the lerp of the children's values, recursing
                         `depth` levels (a child that is itself a
                         composite expands one more level)
  sample                 a stochastic descent to a leaf row (the blend
                         factor is the probability of the second child,
                         u_lobe remapped to stay stratified), then the
                         full mixture pdf for MIS
`depth` is the scene's static nesting depth (SceneStatic.has_blend; 0
calls the leaf BSDFs directly).  The factor is row["blend_value"], which
apply_textures has already set from a mapped blend or mask shader.
`resolve` (the engine's texture callback, or None) re-applies textures to
the gathered child rows at every level.
"""
from __future__ import annotations

import torch

from . import bsdf
from .base import MT_BLEND, MT_MASK, gather_rows


def _blend_factor(row):
    a = torch.where(row["mtype"] == MT_MASK,
                    (row["blend_value"] > row["mask_threshold"]).to(
                        torch.float32),
                    row["blend_value"])
    return torch.clamp(a, 0.0, 1.0)


def _is_composite(row):
    return (row["mtype"] == MT_BLEND) | (row["mtype"] == MT_MASK)


def _child_rows(mats, row, resolve=None):
    m = mats["__pack__"].shape[0]
    ra = gather_rows(mats, torch.clamp(row["sub_mat1"], 0, m - 1).long())
    rb = gather_rows(mats, torch.clamp(row["sub_mat2"], 0, m - 1).long())
    if resolve is not None:
        ra = resolve(ra)
        rb = resolve(rb)
    return ra, rb


def eval_bsdf(mats, row, n, ng, wo, wi, depth: int, families,
              resolve=None):
    f = bsdf.eval_bsdf(row, n, ng, wo, wi, families)
    if not depth:
        return f
    ra, rb = _child_rows(mats, row, resolve)
    a = _blend_factor(row)[..., None]
    fa = eval_bsdf(mats, ra, n, ng, wo, wi, depth - 1, families, resolve)
    fb = eval_bsdf(mats, rb, n, ng, wo, wi, depth - 1, families, resolve)
    return torch.where(_is_composite(row)[..., None], (1.0 - a) * fa + a * fb,
                       f)


def pdf_bsdf(mats, row, n, ng, wo, wi, depth: int, families, resolve=None):
    p = bsdf.pdf_bsdf(row, n, ng, wo, wi, families)
    if not depth:
        return p
    ra, rb = _child_rows(mats, row, resolve)
    a = _blend_factor(row)
    pa = pdf_bsdf(mats, ra, n, ng, wo, wi, depth - 1, families, resolve)
    pb = pdf_bsdf(mats, rb, n, ng, wo, wi, depth - 1, families, resolve)
    return torch.where(_is_composite(row), (1.0 - a) * pa + a * pb, p)


def sample_bsdf(mats, row, n, ng, wo, u1, u2, u_lobe, depth: int, families,
                resolve=None, wavelength=None):
    """The leaf BSDF's sample after the stochastic descent; wavelength
    (the dispersion lane, or None) goes through to the leaf."""
    if not depth:
        return bsdf.sample_bsdf(row, n, ng, wo, u1, u2, u_lobe, families,
                                wavelength)
    comp_top = _is_composite(row)
    cur = row
    for _ in range(depth):
        comp = _is_composite(cur)
        ra, rb = _child_rows(mats, cur, resolve)
        a = _blend_factor(cur)
        pick_b = u_lobe < a
        u_rem = torch.where(pick_b, u_lobe / torch.clamp(a, min=1e-8),
                            (u_lobe - a) / torch.clamp(1.0 - a, min=1e-8))
        u_lobe = torch.where(comp, torch.clamp(u_rem, 0.0, 1.0 - 1e-7),
                             u_lobe)
        nxt = {}
        for k, v in cur.items():
            c, pb = ((comp, pick_b) if v.dim() == 1
                     else (comp[..., None], pick_b[..., None]))
            nxt[k] = torch.where(c, torch.where(pb, rb[k], ra[k]), v)
        cur = nxt
    out = bsdf.sample_bsdf(cur, n, ng, wo, u1, u2, u_lobe, families,
                           wavelength)
    # the full mixture pdf on composite non-delta samples
    mix_pdf = pdf_bsdf(mats, row, n, ng, wo, out["wi"], depth, families,
                       resolve)
    out["pdf"] = torch.where(comp_top & ~out["specular"], mix_pdf,
                             out["pdf"])
    return out


def emission(mats, row, ng, wo, depth: int, resolve=None):
    e = bsdf.emission(row, ng, wo)
    if not depth:
        return e
    ra, rb = _child_rows(mats, row, resolve)
    a = _blend_factor(row)[..., None]
    ea = emission(mats, ra, ng, wo, depth - 1, resolve)
    eb = emission(mats, rb, ng, wo, depth - 1, resolve)
    return torch.where(_is_composite(row)[..., None], (1.0 - a) * ea + a * eb,
                       e)
