"""The port's batch preparation and augmentation
(deepfluoro_tpu_torch.data.augment) against the JAX package's
(deepfluoro_tpu.data.augment).

Torch cannot reproduce JAX's random streams, so the augmented chain is
held by feeding ``apply_augmentation`` the very draws JAX makes from a key
(re-derived here with jax.random along augment.py's key split), and the
torch draws are held to their ranges by their distributions.

Tolerances: atol 1e-5 where both sides run the same float32 formulas
(no augmentation); with augmentation atol 1e-4 on the projection and the
landmarks, because the affine matrices come from each library's own
sin/cos/tan, which differ in the last bit; labels by the share of
differing pixels (< 0.1 %), because the warps round nearest ties
differently (see test_torch_port_warp.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepfluoro_tpu.data import augment as jaug
from deepfluoro_tpu.data.fixtures import make_specimen
from deepfluoro_tpu.data.hdf5 import mark_oob_landmarks_inf
from deepfluoro_tpu_torch.data import augment as taug

DIM, PAD = 40, 48


def _batch(b=4, seed=3):
    projs, segs, lands = make_specimen(np.random.default_rng(seed), b, DIM)
    return projs, segs, mark_oob_landmarks_inf(lands, (DIM, DIM))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_prepare_without_augmentation_matches_jax():
    projs, segs, lands = _batch()
    jcfg = jaug.AugmentConfig(num_classes=7, proj_pad_dim=PAD, prob_of_aug=0.0)
    want = jaug.prepare_batch(jcfg, jax.random.PRNGKey(0), jnp.asarray(projs), jnp.asarray(segs), jnp.asarray(lands))
    got = taug.prepare_batch(taug.AugmentConfig(num_classes=7, proj_pad_dim=PAD, prob_of_aug=0.0), None, _t(projs), _t(segs), _t(lands))
    np.testing.assert_allclose(got["proj"].numpy(), np.asarray(want["proj"]).transpose(0, 3, 1, 2), atol=1e-5)
    np.testing.assert_array_equal(got["seg"].numpy(), np.asarray(want["seg"]).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(got["lands"].numpy(), np.asarray(want["lands"]))
    np.testing.assert_allclose(got["heats"].numpy(), np.asarray(want["heats"]).transpose(0, 3, 1, 2), atol=1e-5)
    assert got["proj"].shape == (4, 1, PAD, PAD)


def _jax_draws(cfg, key, h, w):
    """The draws of augment.py::_augment_proj_seg_lands for one sample key,
    in the same key split and the same call order."""
    hp = h + 2 * jaug._extra_pad(cfg, h)
    keys = jax.random.split(key, 16)
    trans = jax.random.normal(keys[5], (2,))
    trans = trans / jnp.linalg.norm(trans)
    trans = trans * jax.random.uniform(keys[6]) * 20.0
    d = {
        "invert": jax.random.uniform(keys[0]) < 0.5,
        "sigma": jax.random.uniform(keys[1], minval=0.005, maxval=0.01),
        "noise": jax.random.normal(keys[2], (h, w)),
        "gamma": jax.random.uniform(keys[3], minval=0.7, maxval=1.3),
        "rot": jax.random.uniform(keys[4], minval=-5.0, maxval=5.0),
        "trans": trans,
        "shear": jax.random.uniform(keys[7], (2,), minval=-1.0, maxval=1.0),
        "scale": jax.random.uniform(keys[8], minval=0.9, maxval=1.1),
        "erase": jax.random.uniform(keys[9]) < cfg.erase_prob,
        "num_boxes": jax.random.randint(keys[10], (), 1, cfg.max_erase_boxes + 1),
    }
    normals, uniforms, noises = [], [], []
    for bk in jax.random.split(keys[11], cfg.max_erase_boxes):
        bk = jax.random.split(bk, 4)
        normals.append(jax.random.normal(bk[0], (2,)))
        uniforms.append(jnp.stack([jax.random.uniform(bk[1]), jax.random.uniform(bk[2])]))
        noises.append(jax.random.normal(bk[3], (hp, hp)))
    d["box_normal"] = jnp.stack(normals)
    d["box_uniform"] = jnp.stack(uniforms)
    d["box_noise"] = jnp.stack(noises)
    return d


@pytest.mark.parametrize("erase_prob", [1.0, 0.25])
def test_apply_augmentation_with_jax_draws_matches_jax(erase_prob):
    projs, segs, lands = _batch(b=4, seed=5)
    jcfg = jaug.AugmentConfig(num_classes=7, proj_pad_dim=PAD, erase_prob=erase_prob, use_pallas_warp=False)
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    per = [_jax_draws(jcfg, k, DIM, DIM) for k in keys]
    draws = {name: torch.from_numpy(np.stack([np.asarray(d[name]) for d in per])) for name in per[0]}
    draws["num_boxes"] = draws["num_boxes"].long()

    tcfg = taug.AugmentConfig(num_classes=7, proj_pad_dim=PAD)
    p, s, l = taug.apply_augmentation(draws, _t(projs), _t(segs), _t(lands), tcfg)
    assert p.shape == (4, PAD, PAD) and s.shape == (4, DIM, DIM) and l.shape == lands.shape
    for i, k in enumerate(keys):
        wp, ws, wl = jaug._augment_proj_seg_lands(
            jcfg, k, jnp.asarray(projs[i]), jnp.asarray(segs[i]), jnp.asarray(lands[i])
        )
        np.testing.assert_allclose(p[i].numpy(), np.asarray(wp), atol=1e-4)
        assert (s[i].numpy() != np.asarray(ws)).mean() < 0.001
        wl = np.asarray(wl)
        np.testing.assert_array_equal(np.isinf(l[i].numpy()), np.isinf(wl))
        np.testing.assert_allclose(l[i].numpy()[np.isfinite(wl)], wl[np.isfinite(wl)], atol=1e-4)
    # the keys exercise both sides of the invert gate
    assert 0 < int(draws["invert"].sum()) < 4


def test_draw_distributions():
    cfg = taug.AugmentConfig(proj_pad_dim=12)  # 8 -> 12: erase noise in the padded frame
    gen = torch.Generator().manual_seed(0)
    n = 4000
    d = taug.draw_augmentation(gen, n, 8, 8, cfg)
    for gate, p in (("aug", 0.5), ("invert", 0.5), ("erase", 0.25)):
        assert d[gate].dtype == torch.bool and abs(d[gate].float().mean().item() - p) < 0.03, gate
    for name, lo, hi in (("sigma", 0.005, 0.01), ("gamma", 0.7, 1.3), ("rot", -5.0, 5.0), ("scale", 0.9, 1.1), ("shear", -1.0, 1.0)):
        v = d[name]
        assert v.min() >= lo and v.max() < hi, name
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.03 * (hi - lo), name
    radius = torch.linalg.vector_norm(d["trans"], dim=1)
    assert radius.max() <= 20.0 + 1e-4 and abs(radius.mean().item() - 10.0) < 0.5
    angle = torch.atan2(d["trans"][:, 1], d["trans"][:, 0])
    assert abs(torch.cos(angle).mean().item()) < 0.05 and abs(torch.sin(angle).mean().item()) < 0.05
    counts = torch.bincount(d["num_boxes"], minlength=6)
    assert counts[0] == 0 and ((counts[1:].float() / n - 0.2).abs() < 0.03).all()
    for name, shape in (("noise", (n, 8, 8)), ("box_noise", (n, 5, 12, 12)), ("box_normal", (n, 5, 2))):
        assert d[name].shape == shape
        assert abs(d[name].mean().item()) < 0.02 and abs(d[name].std().item() - 1.0) < 0.02
    u = d["box_uniform"]
    assert u.min() >= 0 and u.max() < 1 and abs(u.mean().item() - 0.5) < 0.02


def test_gate_keeps_unaugmented_samples():
    projs, segs, lands = _batch(b=6, seed=8)
    cfg = taug.AugmentConfig(num_classes=7, proj_pad_dim=PAD)
    gen = torch.Generator().manual_seed(4)
    gate = taug.draw_augmentation(torch.Generator().manual_seed(4), 6, DIM, DIM, cfg)["aug"]
    assert 0 < int(gate.sum()) < 6
    got = taug.prepare_batch(cfg, gen, _t(projs), _t(segs), _t(lands))
    plain = taug.prepare_batch(taug.AugmentConfig(num_classes=7, proj_pad_dim=PAD, prob_of_aug=0.0), None, _t(projs), _t(segs), _t(lands))
    for key in ("proj", "seg", "lands", "heats"):
        keep = ~gate
        np.testing.assert_array_equal(got[key][keep].numpy(), plain[key][keep].numpy(), err_msg=key)
        assert not torch.equal(got[key][gate], plain[key][gate]), key
