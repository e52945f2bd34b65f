"""Lane-wise BSDF eval / sample / pdf / emission over gathered material rows.

Port of libyafaray_tpu/materials/bsdf.py for the families the port
renders, which are all of the reference's: null (pass-through),
shinydiffuse, glossy and coated-glossy (Ashikhmin-Shirley under an optional
dielectric coat), smooth glass (delta lobes: eval and pdf are 0), rough
glass (a Walter-07 microfacet dielectric on the Blinn half-vector sampler:
a non-delta lobe that NEE and MIS see through eval and pdf), dispersion
(a glass with dispersion_power > 0 samples a wavelength for a chromatic
lane that it transmits, when the caller carries a wavelength lane) and
light.  Blend and mask composites have no lobe of their own here:
`materials/blend.py` resolves them into their children's rows and calls
these functions on those.
"""
from __future__ import annotations

import torch

from ..core import math as vmath
from ..core.color import cauchy_coefficients, cauchy_ior, luminance, wl_to_rgb
from ..core.qmc import hash_u32, u32, u32_to_float
from ..core.sampling import INV_PI, PI, sample_cos_hemisphere
from .base import (
    MT_BLEND, MT_COATED_GLOSSY, MT_GLASS, MT_GLOSSY, MT_LIGHT, MT_MASK,
    MT_NULL, MT_ROUGH_GLASS, MT_SHINYDIFFUSE, SUPPORTED_FAMILIES,
    glossy_eval_local, glossy_pdf_local, oren_nayar_factor, sample_blinn_h,
    shinydiffuse_weights,
)

_MIN_PDF = 1e-6


# the row entries eval_bsdf / pdf_bsdf read (the engine tiles only these
# for the batched NEE lanes), those the glossy families add, and those
# materials/blend.py reads at a composite
EVAL_KEYS = ("mtype", "diffuse_color", "sigma", "fresnel_effect", "ior",
             "specular_reflect", "transparency", "translucency",
             "diffuse_reflect")
GLOSSY_EVAL_KEYS = ("glossy_reflect", "glossy_color", "exponent", "exp_u",
                    "exp_v", "anisotropic")
BLEND_EVAL_KEYS = ("sub_mat1", "sub_mat2", "blend_value", "mask_threshold")
ROUGH_GLASS_EVAL_KEYS = ("exponent", "mirror_color", "filter_color")


def check_families(families) -> None:
    """Raise for a material family the port does not render yet."""
    for code in families:
        if code not in SUPPORTED_FAMILIES:
            raise NotImplementedError(
                f"material family {code} is not ported yet: ROADMAP Queue 1")


def _has_glossy(families) -> bool:
    return MT_GLOSSY in families or MT_COATED_GLOSSY in families


def eval_keys(families) -> tuple:
    """The row entries eval_bsdf and pdf_bsdf (and blend.py's composites)
    read for these families."""
    keys = EVAL_KEYS + (GLOSSY_EVAL_KEYS if _has_glossy(families) else ())
    if MT_ROUGH_GLASS in families:
        keys += tuple(k for k in ROUGH_GLASS_EVAL_KEYS if k not in keys)
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


def _rough_glass_terms(row, n, ng, wo, wi):
    """Walter-07 microfacet dielectric terms of an arbitrary (wo, wi) pair
    in the Blinn convention: D = (e+2)/(2π)·cosᵉθh, half-vector pdf
    Ph = (e+1)/(2π)·cosᵉθh (sample_blinn_h), V-cavity G, radiance
    transport (the η² form, so the smooth limit is the delta glass).
    Returns (f (N,3), pdf (N,))."""
    entering = vmath.dot(ng, wo) > 0.0
    ior = torch.clamp(row["ior"], min=1.0 + 1e-6)
    eta = torch.where(entering, ior, torch.ones_like(ior) / ior)
    nf = vmath.face_forward(n, wo)
    cos_o = torch.clamp(vmath.dot(nf, wo), min=1e-6)
    cos_i = vmath.dot(nf, wi)
    refl = cos_i > 0.0
    abs_ci = torch.clamp(cos_i.abs(), min=1e-6)
    h = torch.where(refl[..., None], wo + wi, -(wo + eta[..., None] * wi))
    h = vmath.normalize(h)
    h = torch.where(vmath.dot(h, nf)[..., None] < 0.0, -h, h)
    hz = torch.clamp(vmath.dot(h, nf), 1e-6, 1.0)
    oh = vmath.dot(wo, h)
    ih = vmath.dot(wi, h)
    e = row["exponent"]
    cos_pow = torch.pow(hz, e)
    d_ndf = (e + 2.0) / (2.0 * PI) * cos_pow
    p_h = (e + 1.0) / (2.0 * PI) * cos_pow
    abs_oh = torch.clamp(oh.abs(), min=1e-6)
    g = torch.clamp(torch.minimum(2.0 * hz * cos_o / abs_oh,
                                  2.0 * hz * abs_ci / abs_oh), max=1.0)
    fr = vmath.fresnel_dielectric(abs_oh, eta)
    f_r = (fr * d_ndf * g / (4.0 * cos_o * abs_ci))[..., None] \
        * row["mirror_color"]
    pdf_r = fr * p_h / (4.0 * abs_oh)
    jdenom = oh + eta * ih
    j2 = torch.clamp(jdenom * jdenom, min=1e-8)
    abs_ih = ih.abs()
    f_t = (abs_oh * abs_ih / (cos_o * abs_ci)
           * eta * eta * (1.0 - fr) * d_ndf * g / j2)[..., None] \
        * row["filter_color"]
    pdf_t = (1.0 - fr) * p_h * eta * eta * abs_ih / j2
    # transmission only where wo and wi straddle the surface and the
    # half-vector geometry is physical (oh > 0 > ih about h)
    t_ok = (~refl) & (oh > 0.0) & (ih < 0.0)
    f = torch.where(refl[..., None], f_r,
                    torch.where(t_ok[..., None], f_t, 0.0))
    pdf = torch.where(refl, pdf_r, torch.where(t_ok, pdf_t, 0.0))
    return f, pdf


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
    if MT_ROUGH_GLASS in families:
        f_rg, _ = _rough_glass_terms(row, n, ng, wo, wi)
        f = torch.where((row["mtype"] == MT_ROUGH_GLASS)[..., None], f_rg, f)
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
    if MT_ROUGH_GLASS in families:
        _, pdf_rg = _rough_glass_terms(row, n, ng, wo, wi)
        pdf = torch.where(row["mtype"] == MT_ROUGH_GLASS, pdf_rg, pdf)
    return pdf


def sample_bsdf(row, n, ng, wo, u1, u2, u_lobe, families,
                wavelength=None) -> dict:
    """Sample a continuation direction for every lane.

    wavelength: an optional (N,) spectral lane, < 0 for a chromatic lane.
    A dispersive glass (dispersion_power > 0) that transmits a chromatic
    lane draws it a wavelength (Cauchy IOR, the wl_to_rgb weight folded
    into tp), returned in `new_wavelength`, present iff wavelength is
    given.  Without it a dispersive glass is glass at its base IOR.

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

    glass_fams = MT_GLASS in families or MT_ROUGH_GLASS in families
    rough_fam = MT_ROUGH_GLASS in families
    new_wl = wavelength
    if MT_NULL in families or glass_fams:
        # the reference's glass-family block: Fresnel pick between the
        # mirror and the refracted direction around nf (rough glass: around
        # a sampled half-vector); null is glass at eta = 1 with no Fresnel
        # reflection unless the refraction fails (TIR -> reflect) and a
        # throughput of 1 (a null-only table skips the glass terms)
        if glass_fams:
            is_rough = mtype == MT_ROUGH_GLASS
            is_glass = is_null | (mtype == MT_GLASS) | is_rough
            ior = torch.clamp(row["ior"], min=1.0 + 1e-6)
            if wavelength is not None:
                # a chromatic lane on a dispersive glass draws a wavelength
                # from a hash of u1 (not a QMC dimension of its own)
                dispersive = row["dispersion_power"] > 1e-6
                u_wl = u32_to_float(hash_u32(
                    u32((u1 * 16777216.0).to(torch.int64)) ^ 0x5157)) \
                    * (1.0 / 4294967296.0)
                need_wl = dispersive & (wavelength < 0.0)
                wl_here = torch.where(need_wl, u_wl, wavelength)
                a_c, b_c = cauchy_coefficients(ior, row["dispersion_power"])
                ior_wl = cauchy_ior(a_c, b_c, torch.clamp(wl_here, 0.0, 1.0))
                ior = torch.where(dispersive & (wl_here >= 0.0), ior_wl, ior)
                # the spectral weight, once, when the wavelength is drawn
                wl_weight = torch.where(need_wl[..., None],
                                        wl_to_rgb(wl_here), 1.0)
                new_wl = wl_here
            eta = torch.where(entering, ior, torch.ones_like(ior) / ior)
            eta = torch.where(is_null, 1.0, eta)
            if rough_fam:
                u, v = vmath.build_onb(nf)
                h_l = sample_blinn_h(row, u1, u2)
                h_used = torch.where(is_rough[..., None],
                                     vmath.from_local(u, v, nf, h_l), nf)
            else:
                h_used = nf
            cos_oh = vmath.dot(h_used, wo).abs()
            kr = vmath.fresnel_dielectric(cos_oh, eta)
            kr = torch.where(is_null, 0.0, kr)
            wi_refr, refr_ok = vmath.refract(wo, h_used, eta)
            kr = torch.where(refr_ok, kr, 1.0)  # TIR
            pick_refl = u_lobe < kr
            tp_refl = torch.where(refr_ok[..., None], row["mirror_color"],
                                  1.0)
            gs_tp = torch.where(pick_refl[..., None], tp_refl,
                                row["filter_color"])
            if wavelength is not None:
                gs_tp = torch.where((~pick_refl & dispersive)[..., None],
                                    gs_tp * wl_weight, gs_tp)
            gs_tp = torch.where(is_null[..., None], 1.0, gs_tp)
        else:
            is_glass = is_null
            h_used = nf
            wi_refr, refr_ok = vmath.refract_unit_eta(wo, nf)
            pick_refl = u_lobe < torch.where(refr_ok, 0.0, 1.0)
            gs_tp = 1.0
        gs_wi = torch.where(pick_refl[..., None], vmath.reflect(wo, h_used),
                            wi_refr)
        glass_pdf = 0.0
        glass_valid = True
        if rough_fam:
            # microfacet weighting (Walter-07 with the Blinn-h sampler):
            # tp ×= G·|oh|·(e+2)/((e+1)·cosθo), since D/Ph = (e+2)/(e+1)
            # and F/(1-F) cancel against the lobe pick; a solid-angle pdf
            # so NEE and MIS see rough transmission
            e_b = row["exponent"]
            hz_s = torch.clamp(h_l[..., 2], 1e-6, 1.0)
            cos_o_c = torch.clamp(cos_o.abs(), min=1e-6)
            cos_i_s = torch.clamp(vmath.dot(nf, gs_wi).abs(), min=1e-6)
            coh = torch.clamp(cos_oh, min=1e-6)
            k_g = torch.clamp(torch.minimum(2.0 * hz_s * cos_o_c / coh,
                                            2.0 * hz_s * cos_i_s / coh),
                              max=1.0)
            k_rough = (k_g * cos_oh * (e_b + 2.0)
                       / ((e_b + 1.0) * cos_o_c))
            gs_tp = gs_tp * torch.where(is_rough, k_rough, 1.0)[..., None]
            p_h = (e_b + 1.0) / (2.0 * PI) * torch.pow(hz_s, e_b)
            ih_s = vmath.dot(gs_wi, h_used)
            j_t = cos_oh + eta * ih_s
            pdf_rough = torch.where(
                pick_refl, kr * p_h / (4.0 * coh),
                (1.0 - kr) * p_h * eta * eta * ih_s.abs()
                / torch.clamp(j_t * j_t, min=1e-8))
            glass_pdf = torch.where(is_rough, pdf_rough, 0.0)
            # a wide lobe's half-vector can reflect below or refract above
            # the surface: Walter-07 drops those samples
            cos_gs = vmath.dot(nf, gs_wi)
            side_ok = torch.where(pick_refl, cos_gs > 0.0, cos_gs < 0.0)
            glass_valid = ~is_rough | side_ok
        wi = torch.where(is_glass[..., None], gs_wi, wi)
        tp = torch.where(is_glass[..., None], gs_tp, tp)
        pdf = torch.where(is_glass, glass_pdf, pdf)
        specular = torch.where(is_glass, ~is_rough if rough_fam else True,
                               specular)
        transmit = torch.where(is_glass, ~pick_refl, transmit)
        valid = torch.where(is_glass, glass_valid, valid)

    valid = valid & (luminance(tp.abs()) > 1e-7)
    out = dict(
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
    if wavelength is not None:
        # a lane keeps its wavelength once drawn; a chromatic one takes the
        # drawn one only where a dispersive glass transmitted it
        out["new_wavelength"] = wavelength
        if glass_fams:
            became = is_glass & dispersive & transmit & (wavelength < 0.0)
            out["new_wavelength"] = torch.where(
                became | (wavelength >= 0.0), new_wl, wavelength)
    return out


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
