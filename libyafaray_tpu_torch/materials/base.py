"""Material system — SoA parameter table + per-family BSDF math.

Port of libyafaray_tpu/materials/base.py: the MT_* codes, the table layout
(`build_material_table`, identical columns so the packed matrix matches
the reference's), `gather_rows`, and the shinydiffuse and glossy
(Ashikhmin-Shirley) lobe math the ported slices call.  The table build is
numpy; `gather_rows` runs on tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as vmath
from ..core.sampling import INV_PI, PI

# material type codes
MT_NULL = 0
MT_SHINYDIFFUSE = 1
MT_GLOSSY = 2
MT_COATED_GLOSSY = 3
MT_GLASS = 4
MT_ROUGH_GLASS = 5
MT_BLEND = 6
MT_MASK = 7
MT_LIGHT = 8

MATERIAL_TYPE_NAMES = {
    "null": MT_NULL,
    "shinydiffusemat": MT_SHINYDIFFUSE,
    "glossy": MT_GLOSSY,
    "coated_glossy": MT_COATED_GLOSSY,
    "glass": MT_GLASS,
    "rough_glass": MT_ROUGH_GLASS,
    "blend_mat": MT_BLEND,
    "mask_mat": MT_MASK,
    "light_mat": MT_LIGHT,
}

# the families the port renders (blend and mask through
# materials/blend.py): all of the reference's
SUPPORTED_FAMILIES = (MT_NULL, MT_SHINYDIFFUSE, MT_GLOSSY, MT_COATED_GLOSSY,
                      MT_GLASS, MT_ROUGH_GLASS, MT_BLEND, MT_MASK, MT_LIGHT)

_SCALAR_COLS = [
    "diffuse_reflect", "specular_reflect", "transparency", "translucency",
    "emit_strength", "ior", "sigma", "exponent", "exp_u", "exp_v",
    "glossy_reflect", "dispersion_power", "blend_value", "mask_threshold",
    "wireframe_amount", "tex_colorfac", "bump_strength",
    "sampling_factor", "additional_depth",
]
_VEC3_COLS = [
    "diffuse_color", "mirror_color", "glossy_color", "filter_color",
    "absorption_sigma", "emit_color", "mask_color",
]
_INT_COLS = ["mtype", "sub_mat1", "sub_mat2", "tex_blend_mode",
             "tex_diffuse", "tex_glossy", "tex_bump", "tex_mirror",
             "tex_transparency", "tex_translucency", "tex_blend", "tex_mask",
             "tex_sigma_oren", "tex_ior",
             "node_prog"]
_BOOL_COLS = ["fresnel_effect", "anisotropic", "as_diffuse", "fake_shadows",
              "double_sided", "receive_shadows"]


def default_row() -> dict:
    row = {c: 0.0 for c in _SCALAR_COLS}
    row.update({c: (0.0, 0.0, 0.0) for c in _VEC3_COLS})
    row.update({c: -1 for c in _INT_COLS})
    row.update({c: False for c in _BOOL_COLS})
    row["mtype"] = MT_NULL
    row["ior"] = 1.0
    row["bump_strength"] = 1.0
    row["diffuse_reflect"] = 1.0
    row["glossy_reflect"] = 1.0
    row["receive_shadows"] = True
    row["tex_colorfac"] = 1.0
    row["tex_blend_mode"] = 0  # mix
    row["sampling_factor"] = 1.0
    return row


def build_material_table(rows: list[dict]) -> dict:
    """host rows -> dict of numpy SoA arrays, plus `__pack__`: all columns
    concatenated into one (M, C) f32 matrix so a lane's parameters are one
    gather."""
    if not rows:
        rows = [default_row()]
    out = {}
    for c in _SCALAR_COLS:
        out[c] = np.asarray([r[c] for r in rows], np.float32)
    for c in _VEC3_COLS:
        out[c] = np.asarray([r[c] for r in rows], np.float32).reshape(
            len(rows), 3)
    for c in _INT_COLS:
        out[c] = np.asarray([r[c] for r in rows], np.int32)
    for c in _BOOL_COLS:
        out[c] = np.asarray([r[c] for r in rows], np.bool_)
    packed = [out[c][:, None].astype(np.float32) for c in _SCALAR_COLS]
    packed += [out[c].astype(np.float32) for c in _VEC3_COLS]
    packed += [out[c][:, None].astype(np.float32) for c in _INT_COLS]
    packed += [out[c][:, None].astype(np.float32) for c in _BOOL_COLS]
    out["__pack__"] = np.concatenate(packed, axis=1)
    return out


def gather_rows(mats: dict, mid: torch.Tensor) -> dict:
    """Per-lane material parameters: one packed gather + free slicing."""
    p = mats["__pack__"][mid]  # (N, C)
    row = {}
    o = 0
    for c in _SCALAR_COLS:
        row[c] = p[:, o]
        o += 1
    for c in _VEC3_COLS:
        row[c] = p[:, o:o + 3]
        o += 3
    for c in _INT_COLS:
        row[c] = p[:, o].to(torch.int32)
        o += 1
    for c in _BOOL_COLS:
        row[c] = p[:, o] > 0.5
        o += 1
    return row


def oren_nayar_factor(sigma, n, wo, wi):
    """Qualitative Oren-Nayar multiplier on the Lambert lobe (1 where
    sigma is 0)."""
    s2 = sigma * sigma
    a = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b = 0.45 * s2 / (s2 + 0.09)
    cos_o = torch.clamp(vmath.dot(n, wo), -1.0, 1.0)
    cos_i = torch.clamp(vmath.dot(n, wi), -1.0, 1.0)
    sin_o = vmath.sqrt_rn(torch.clamp(1.0 - cos_o * cos_o, min=0.0))
    sin_i = vmath.sqrt_rn(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    wo_t = wo - cos_o[..., None] * n
    wi_t = wi - cos_i[..., None] * n
    denom = torch.clamp(vmath.length(wo_t) * vmath.length(wi_t), min=1e-9)
    cos_dphi = torch.clamp(vmath.dot(wo_t, wi_t) / denom, -1.0, 1.0)
    sin_alpha = torch.maximum(sin_o, sin_i)
    tan_beta = torch.minimum(sin_o, sin_i) / torch.clamp(
        torch.maximum(cos_o.abs(), cos_i.abs()), min=1e-3)
    on = a + b * torch.clamp(cos_dphi, min=0.0) * sin_alpha * tan_beta
    return torch.where(sigma > 1e-6, on, 1.0)


def _as_exponent(row: dict, hx, hy, hz):
    """Ashikhmin-Shirley exponent: isotropic `exponent` or the anisotropic
    combination of exp_u / exp_v by the half-vector azimuth."""
    denom = torch.clamp(1.0 - hz * hz, min=1e-8)
    e_aniso = (row["exp_u"] * hx * hx + row["exp_v"] * hy * hy) / denom
    return torch.where(row["anisotropic"], e_aniso, row["exponent"])


def glossy_eval_local(row: dict, wo_l, wi_l):
    """Ashikhmin-Shirley glossy lobe and its coupled diffuse, in the local
    shading frame (z = normal).  Returns (f_glossy (N,3), f_diffuse (N,3))."""
    cos_o = torch.clamp(wo_l[..., 2], min=0.0)
    cos_i = torch.clamp(wi_l[..., 2], min=0.0)
    h = vmath.normalize(wo_l + wi_l)
    hz = torch.clamp(h[..., 2], -1.0, 1.0)
    e = _as_exponent(row, h[..., 0], h[..., 1], hz)
    wo_h = torch.clamp(vmath.dot(wo_l, h), min=1e-6)
    norm_iso = (row["exponent"] + 1.0) / (8.0 * PI)
    norm_aniso = vmath.sqrt_rn(torch.clamp(
        (row["exp_u"] + 1.0) * (row["exp_v"] + 1.0), min=0.0)) / (8.0 * PI)
    norm = torch.where(row["anisotropic"], norm_aniso, norm_iso)
    d = torch.pow(torch.clamp(hz, min=0.0), e)
    denom = wo_h * torch.clamp(torch.maximum(cos_o, cos_i), min=1e-6)
    rs = row["glossy_reflect"]
    fr = rs + (1.0 - rs) * torch.pow(1.0 - wo_h, 5.0)  # Schlick on the lobe
    spec = norm * d / denom * fr
    f_glossy = spec[..., None] * row["glossy_color"]
    # AS coupled diffuse (energy-compensated Lambert)
    k = 28.0 / (23.0 * PI)
    t_o = 1.0 - torch.pow(1.0 - 0.5 * cos_o, 5.0)
    t_i = 1.0 - torch.pow(1.0 - 0.5 * cos_i, 5.0)
    fd = k * row["diffuse_reflect"] * (1.0 - rs) * t_o * t_i
    f_diffuse = fd[..., None] * row["diffuse_color"]
    valid = ((cos_o > 1e-6) & (cos_i > 1e-6))[..., None]
    return (torch.where(valid, f_glossy, 0.0),
            torch.where(valid, f_diffuse, 0.0))


def glossy_pdf_local(row: dict, wo_l, wi_l, p_diffuse):
    """Mixture pdf of the glossy sampler (cosine + Blinn / AS half-vector)."""
    cos_i = torch.clamp(wi_l[..., 2], min=0.0)
    pdf_d = cos_i * INV_PI
    h = vmath.normalize(wo_l + wi_l)
    hz = torch.clamp(h[..., 2], 0.0, 1.0)
    e = _as_exponent(row, h[..., 0], h[..., 1], hz)
    wo_h = torch.clamp(vmath.dot(wo_l, h), min=1e-6)
    norm_iso = (row["exponent"] + 1.0) / (2.0 * PI)
    norm_aniso = vmath.sqrt_rn(torch.clamp(
        (row["exp_u"] + 1.0) * (row["exp_v"] + 1.0), min=0.0)) / (2.0 * PI)
    norm = torch.where(row["anisotropic"], norm_aniso, norm_iso)
    pdf_h = norm * torch.pow(hz, e)
    pdf_g = pdf_h / (4.0 * wo_h)
    return p_diffuse * pdf_d + (1.0 - p_diffuse) * pdf_g


def sample_blinn_h(row: dict, u1, u2):
    """Half-vector from the Blinn (isotropic) or AS-anisotropic NDF, in the
    local frame."""
    e_iso = row["exponent"]
    # the sampled direction's pow, cos and sin through float64 on every
    # device, so the card's half-vectors are the CPU's bit for bit
    cos_h_iso = torch.pow(torch.clamp(u1, 1e-9, 1.0).double(),
                          (1.0 / (e_iso + 1.0)).double()).float()
    phi_iso = 2.0 * PI * u2
    # anisotropic (AS): per-quadrant phi warp
    eu, ev = row["exp_u"], row["exp_v"]
    q = torch.floor(u1 * 4.0)
    u1q = torch.clamp(u1 * 4.0 - q, 1e-9, 1.0 - 1e-7)
    phi_q = torch.atan(vmath.sqrt_rn((eu + 1.0) / torch.clamp(ev + 1.0,
                                                           min=1e-6))
                       * torch.tan(0.5 * PI * u1q))
    phi_aniso = torch.where(
        q == 0, phi_q,
        torch.where(q == 1, PI - phi_q,
                    torch.where(q == 2, PI + phi_q, 2 * PI - phi_q)))
    cphi_a, sphi_a = torch.cos(phi_aniso), torch.sin(phi_aniso)
    e_a = eu * cphi_a * cphi_a + ev * sphi_a * sphi_a
    cos_h_aniso = torch.pow(torch.clamp(u2, 1e-9, 1.0), 1.0 / (e_a + 1.0))
    use_a = row["anisotropic"]
    cos_h = torch.where(use_a, cos_h_aniso, cos_h_iso)
    phi = torch.where(use_a, phi_aniso, phi_iso)
    sin_h = vmath.sqrt_rn(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    return torch.stack([sin_h * vmath.cos_rn(phi), sin_h * vmath.sin_rn(phi),
                        cos_h], dim=-1)


def shinydiffuse_weights(row: dict, cos_o: torch.Tensor):
    """Returns (w_mirror, w_transp, w_transl, w_diff) lane scalars after the
    sequential energy split; fresnel_effect modulates the mirror share."""
    kr = torch.where(
        row["fresnel_effect"],
        vmath.fresnel_dielectric(cos_o.abs(),
                                 torch.clamp(row["ior"], min=1.0 + 1e-5)),
        1.0,
    )
    acc = torch.ones_like(cos_o)
    w_mirror = row["specular_reflect"] * kr * acc
    acc = acc * (1.0 - row["specular_reflect"] * kr)
    w_transp = row["transparency"] * acc
    acc = acc * (1.0 - row["transparency"])
    w_transl = row["translucency"] * acc
    acc = acc * (1.0 - row["translucency"])
    w_diff = row["diffuse_reflect"] * acc
    return w_mirror, w_transp, w_transl, w_diff
