"""Lane-wise BSDF eval / sample / pdf / emission over gathered material rows.

Port of libyafaray_tpu/materials/bsdf.py for the families the port
renders: null (pass-through), shinydiffuse, glossy and coated-glossy
(Ashikhmin-Shirley under an optional dielectric coat), smooth glass
(sample only, without dispersion: delta lobes, so eval and pdf are 0) and
light.  Rough glass raises (ROADMAP Queue 1 item 10).  Blend and mask
composites have no lobe of their own here: `materials/blend.py` resolves
them into their children's rows and calls these functions on those.
"""
from __future__ import annotations

import torch

from ..core import math as vmath
from ..core.color import luminance
from ..core.sampling import INV_PI, sample_cos_hemisphere
from .base import (
    MT_BLEND, MT_COATED_GLOSSY, MT_GLASS, MT_GLOSSY, MT_LIGHT, MT_MASK,
    MT_NULL, MT_ROUGH_GLASS, MT_SHINYDIFFUSE, SUPPORTED_FAMILIES,
    glossy_eval_local, glossy_pdf_local, oren_nayar_factor, sample_blinn_h,
    shinydiffuse_weights,
)

_MIN_PDF = 1e-6
_ROADMAP = {
    MT_ROUGH_GLASS: "ROADMAP Queue 1 item 10 (rough glass)",
}


# the row entries eval_bsdf / pdf_bsdf read (the engine tiles only these
# for the batched NEE lanes), those the glossy families add, and those
# materials/blend.py reads at a composite
EVAL_KEYS = ("mtype", "diffuse_color", "sigma", "fresnel_effect", "ior",
             "specular_reflect", "transparency", "translucency",
             "diffuse_reflect")
GLOSSY_EVAL_KEYS = ("glossy_reflect", "glossy_color", "exponent", "exp_u",
                    "exp_v", "anisotropic")
BLEND_EVAL_KEYS = ("sub_mat1", "sub_mat2", "blend_value", "mask_threshold")


def check_families(families) -> None:
    """Raise for a material family the port does not render yet."""
    for code in families:
        if code not in SUPPORTED_FAMILIES:
            raise NotImplementedError(
                f"material family {code} is not ported yet: "
                f"{_ROADMAP.get(code, 'ROADMAP Queue 1')}")


def _has_glossy(families) -> bool:
    return MT_GLOSSY in families or MT_COATED_GLOSSY in families


def eval_keys(families) -> tuple:
    """The row entries eval_bsdf and pdf_bsdf (and blend.py's composites)
    read for these families."""
    keys = EVAL_KEYS + (GLOSSY_EVAL_KEYS if _has_glossy(families) else ())
    if MT_BLEND in families or MT_MASK in families:
        keys += BLEND_EVAL_KEYS
    return keys


def _is_glossy(mtype: torch.Tensor) -> torch.Tensor:
    return (mtype == MT_GLOSSY) | (mtype == MT_COATED_GLOSSY)


def _glossy_pick_prob(row) -> torch.Tensor:
    """Probability of the diffuse lobe in the glossy family's sampler."""
    wd = row["diffuse_reflect"] * luminance(row["diffuse_color"])
    wg = row["glossy_reflect"] * luminance(row["glossy_color"])
    return wd / torch.clamp(wd + wg, min=1e-8)


def _coat_kr(row, cos_o) -> torch.Tensor:
    """Dielectric coat reflectance of coated_glossy; 0 for plain glossy."""
    kr = vmath.fresnel_dielectric(cos_o.abs(),
                                  torch.clamp(row["ior"], min=1.0 + 1e-5))
    return torch.where(row["mtype"] == MT_COATED_GLOSSY, kr, 0.0)


def _local_frame(n, wo):
    """(u, v, nf): the shading frame around n flipped to face wo."""
    nf = vmath.face_forward(n, wo)
    u, v = vmath.build_onb(nf)
    return u, v, nf


def eval_bsdf(row, n, ng, wo, wi, families) -> torch.Tensor:
    """f(wo, wi) of all non-delta lobes. (N,3)."""
    check_families(families)
    cos_o = vmath.dot(n, wo)
    cos_i = vmath.dot(n, wi)
    same_side = (cos_i * cos_o) > 0.0
    f = torch.zeros_like(row["diffuse_color"])
    if MT_SHINYDIFFUSE in families:
        _, _, w_transl, w_diff = shinydiffuse_weights(row, cos_o)
        on = oren_nayar_factor(row["sigma"], n, wo, wi)
        f_diff = (w_diff * on * INV_PI)[..., None] * row["diffuse_color"]
        f_transl = (w_transl * INV_PI)[..., None] * row["diffuse_color"]
        f_shiny = torch.where(same_side[..., None], f_diff, f_transl)
        f = torch.where((row["mtype"] == MT_SHINYDIFFUSE)[..., None],
                        f_shiny, f)
    if _has_glossy(families):
        u, v, nf = _local_frame(n, wo)
        f_g, f_d = glossy_eval_local(row, vmath.to_local(u, v, nf, wo),
                                     vmath.to_local(u, v, nf, wi))
        f_glossy = (f_g + f_d) * (1.0 - _coat_kr(row, cos_o))[..., None]
        f_glossy = torch.where(same_side[..., None], f_glossy, 0.0)
        f = torch.where(_is_glossy(row["mtype"])[..., None], f_glossy, f)
    return f


def pdf_bsdf(row, n, ng, wo, wi, families) -> torch.Tensor:
    """pdf of sample_bsdf for non-delta directions (solid angle). (N,)."""
    check_families(families)
    cos_o = vmath.dot(n, wo)
    cos_i = vmath.dot(n, wi)
    same_side = (cos_i * cos_o) > 0.0
    abs_ci = cos_i.abs()
    pdf = torch.zeros_like(cos_i)
    if MT_SHINYDIFFUSE in families:
        w_m, w_t, w_tl, w_d = shinydiffuse_weights(row, cos_o)
        tot = torch.clamp(w_m + w_t + w_tl + w_d, min=1e-8)
        pdf_shiny = torch.where(
            same_side, (w_d / tot) * abs_ci * INV_PI,
            (w_tl / tot) * abs_ci * INV_PI)
        pdf = torch.where(row["mtype"] == MT_SHINYDIFFUSE, pdf_shiny, pdf)
    if _has_glossy(families):
        u, v, nf = _local_frame(n, wo)
        pdf_glossy = glossy_pdf_local(
            row, vmath.to_local(u, v, nf, wo), vmath.to_local(u, v, nf, wi),
            _glossy_pick_prob(row)) * (1.0 - _coat_kr(row, cos_o))
        pdf_glossy = torch.where(same_side, pdf_glossy, 0.0)
        pdf = torch.where(_is_glossy(row["mtype"]), pdf_glossy, pdf)
    return pdf


def sample_bsdf(row, n, ng, wo, u1, u2, u_lobe, families) -> dict:
    """Sample a continuation direction for every lane.

    Returns dict with wi (N,3), tp (N,3) throughput multiplier (f·|cos|/pdf,
    delta lobes pre-folded), pdf (N,) solid-angle pdf for MIS (0 = delta),
    specular, transmit, entering (a transmission into the object: the
    front of its geometric normal faces wo), valid, passthrough and chain
    (N,) bools."""
    check_families(families)
    cos_o = vmath.dot(n, wo)
    nf = vmath.face_forward(n, wo)
    mtype = row["mtype"]
    n_lanes = cos_o.shape[0]
    dev = cos_o.device
    wi = wo  # placeholder; overwritten per present family
    tp = torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev)
    pdf = torch.zeros((n_lanes,), dtype=torch.float32, device=dev)
    specular = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)
    transmit = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)
    valid = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)
    entering = vmath.dot(ng, wo) > 0.0
    is_null = mtype == MT_NULL

    if MT_SHINYDIFFUSE in families or _has_glossy(families):
        wi_diff, pdf_diff = sample_cos_hemisphere(nf, u1, u2)
        wi_mirror = vmath.reflect(wo, nf)

    if MT_SHINYDIFFUSE in families:
        w_m, w_t, w_tl, w_d = shinydiffuse_weights(row, cos_o)
        tot = torch.clamp(w_m + w_t + w_tl + w_d, min=1e-8)
        p_m, p_t, p_tl = w_m / tot, w_t / tot, w_tl / tot
        c0, c1, c2 = p_m, p_m + p_t, p_m + p_t + p_tl
        pick_m = u_lobe < c0
        pick_t = (~pick_m) & (u_lobe < c1)
        pick_tl = (~pick_m) & (~pick_t) & (u_lobe < c2)
        wi_transl = -wi_diff
        wi_transp = -wo
        sh_wi = torch.where(
            pick_m[..., None], wi_mirror,
            torch.where(pick_t[..., None], wi_transp,
                        torch.where(pick_tl[..., None], wi_transl, wi_diff)))
        on = oren_nayar_factor(row["sigma"], n, wo, wi_diff)
        # diffuse: f·cos/(pdf·p_d), f = w_d·on·ρ/π, pdf = cos/π ⇒ w_d·on·ρ/p_d
        p_d = torch.clamp(1.0 - c2, min=1e-8)
        tp_diff = (w_d * on / p_d)[..., None] * row["diffuse_color"]
        tp_transl = (w_tl / torch.clamp(p_tl, min=1e-8))[..., None] \
            * row["diffuse_color"]
        tp_mirror = (w_m / torch.clamp(p_m, min=1e-8))[..., None] \
            * row["mirror_color"]
        tp_transp = (w_t / torch.clamp(p_t, min=1e-8))[..., None] \
            * row["filter_color"]
        sh_tp = torch.where(
            pick_m[..., None], tp_mirror,
            torch.where(pick_t[..., None], tp_transp,
                        torch.where(pick_tl[..., None], tp_transl, tp_diff)))
        pick_d = (~pick_m) & (~pick_t) & (~pick_tl)
        sh_pdf = torch.where(
            pick_d, pdf_diff * p_d,
            torch.where(pick_tl, pdf_diff * torch.clamp(p_tl, min=1e-8), 0.0))
        m = mtype == MT_SHINYDIFFUSE
        wi = torch.where(m[..., None], sh_wi, wi)
        tp = torch.where(m[..., None], sh_tp, tp)
        pdf = torch.where(m, sh_pdf, pdf)
        specular = torch.where(m, pick_m | pick_t, specular)
        transmit = torch.where(m, pick_t | pick_tl, transmit)
        valid = torch.where(m, tot > 1e-6, valid)

    if _has_glossy(families):
        u, v = vmath.build_onb(nf)
        wo_l = vmath.to_local(u, v, nf, wo)
        p_diff = _glossy_pick_prob(row)
        coat = _coat_kr(row, cos_o)
        pick_coat = u_lobe < coat  # dielectric coat (coated_glossy only)
        u_rem = torch.clamp((u_lobe - coat) / torch.clamp(1.0 - coat,
                                                          min=1e-8),
                            0.0, 1.0)
        pick_gd = u_rem < p_diff  # diffuse under the coat
        h_l = sample_blinn_h(row, u1, u2)
        wo_h = vmath.dot(wo_l, h_l)
        wi_glossy = vmath.from_local(u, v, nf,
                                     2.0 * wo_h[..., None] * h_l - wo_l)
        gl_wi = torch.where(
            pick_coat[..., None], wi_mirror,
            torch.where(pick_gd[..., None], wi_diff, wi_glossy))
        wi_l_pick = vmath.to_local(u, v, nf, gl_wi)
        f_g, f_d = glossy_eval_local(row, wo_l, wi_l_pick)
        f_gl = (f_g + f_d) * (1.0 - coat)[..., None]
        pdf_gl = glossy_pdf_local(row, wo_l, wi_l_pick, p_diff) * (1.0 - coat)
        gl_smooth_tp = f_gl * (wi_l_pick[..., 2].abs()
                               / torch.clamp(pdf_gl, min=_MIN_PDF))[..., None]
        gl_tp = torch.where(pick_coat[..., None], row["mirror_color"],
                            gl_smooth_tp)
        m = _is_glossy(mtype)
        wi = torch.where(m[..., None], gl_wi, wi)
        tp = torch.where(m[..., None], gl_tp, tp)
        pdf = torch.where(m, torch.where(pick_coat, 0.0, pdf_gl), pdf)
        specular = torch.where(m, pick_coat, specular)
        valid = torch.where(m, pick_coat | (wi_l_pick[..., 2] > 1e-6), valid)

    if MT_NULL in families or MT_GLASS in families:
        # the reference's glass-family block: Fresnel pick between the
        # mirror and the refracted direction around nf; null is glass at
        # eta = 1 with no Fresnel reflection unless the refraction fails
        # (TIR -> reflect) and a throughput of 1 (a null-only table skips
        # the glass terms)
        if MT_GLASS in families:
            is_glass = is_null | (mtype == MT_GLASS)
            ior = torch.clamp(row["ior"], min=1.0 + 1e-6)
            eta = torch.where(entering, ior, torch.ones_like(ior) / ior)
            eta = torch.where(is_null, 1.0, eta)
            kr = vmath.fresnel_dielectric(vmath.dot(nf, wo).abs(), eta)
            kr = torch.where(is_null, 0.0, kr)
            wi_refr, refr_ok = vmath.refract(wo, nf, eta)
            pick_refl = u_lobe < torch.where(refr_ok, kr, 1.0)  # TIR
            tp_refl = torch.where(refr_ok[..., None], row["mirror_color"],
                                  1.0)
            gs_tp = torch.where(pick_refl[..., None], tp_refl,
                                row["filter_color"])
            gs_tp = torch.where(is_null[..., None], 1.0, gs_tp)
        else:
            is_glass = is_null
            wi_refr, refr_ok = vmath.refract_unit_eta(wo, nf)
            pick_refl = u_lobe < torch.where(refr_ok, 0.0, 1.0)
            gs_tp = 1.0
        gs_wi = torch.where(pick_refl[..., None], vmath.reflect(wo, nf),
                            wi_refr)
        wi = torch.where(is_glass[..., None], gs_wi, wi)
        tp = torch.where(is_glass[..., None], gs_tp, tp)
        pdf = torch.where(is_glass, 0.0, pdf)
        specular = torch.where(is_glass, True, specular)
        transmit = torch.where(is_glass, ~pick_refl, transmit)
        valid = torch.where(is_glass, True, valid)

    valid = valid & (luminance(tp.abs()) > 1e-7)
    return dict(
        wi=vmath.normalize(wi), tp=tp, pdf=pdf,
        specular=specular, transmit=transmit,
        entering=entering & transmit, valid=valid,
        # null transmission is not a scattering event: callers keep their
        # MIS state (spec_mask/prev_pdf) across it
        passthrough=is_null & transmit,
        # the vertices SPPM's eye pass follows before the first storable
        # hit: specular, and rough glass (non-delta, not diffuse)
        chain=specular | (mtype == MT_ROUGH_GLASS),
    )


def emission(row, ng, wo) -> torch.Tensor:
    """Surface emission toward wo (light_mat power-folded color;
    shinydiffuse `emit` knob)."""
    front = vmath.dot(ng, wo) > 0.0
    vis = front | row["double_sided"]
    e_light = torch.where(vis[..., None], row["emit_color"], 0.0)
    e_shiny = row["emit_strength"][..., None] * row["diffuse_color"]
    mtype = row["mtype"]
    return torch.where(
        (mtype == MT_LIGHT)[..., None], e_light,
        torch.where((mtype == MT_SHINYDIFFUSE)[..., None], e_shiny, 0.0))
