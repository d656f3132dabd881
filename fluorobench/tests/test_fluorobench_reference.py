"""The plain reference against itself, in float64 at tiny sizes on the
CPU."""

import math

import numpy as np
import torch

from fluorobench import weights
from fluorobench.reference import infer as ref_infer
from fluorobench.reference import train as ref_train
from fluorobench.reference import unet
from fluorobench.tests.small import small_cell

CFG = small_cell("train-8x").config
F64 = unet.Numerics(torch.float64)


def shapes(cfg):
    """The reference's state-dict layout for ``cfg`` (depth 2, no program)."""
    out, c_in = {}, 1
    bn = lambda k, c: out.update({k + ".weight": (c,), k + ".bias": (c,), k + ".running_mean": (c,),  # noqa: E731
                                  k + ".running_var": (c,), k + ".num_batches_tracked": ()})
    depth, wf = cfg["depth"], cfg["init_feats_exp"]
    for i in range(depth):
        c = 2 ** (wf + i)
        out["downsample_convs.{}.weight".format(i)], out["downsample_convs.{}.bias".format(i)] = (c, c, 2, 2), (c,)
        out["down_path.{}.res_conv1x1.weight".format(i)] = (c, c_in, 1, 1)
        out["down_path.{}.res_conv1x1.bias".format(i)] = (c,)
        for j, cin in ((0, c_in), (3, c)):
            out["down_path.{}.block.{}.weight".format(i, j)], out["down_path.{}.block.{}.bias".format(i, j)] = (c, cin, 3, 3), (c,)
            bn("down_path.{}.block.{}".format(i, j + 2), c)
        c_in = c
    for k, i in enumerate(reversed(range(depth - 1))):
        c, key = 2 ** (wf + i), "up_path.{}".format(k)
        out[key + ".up.weight"], out[key + ".up.bias"] = (c_in, c, 2, 2), (c,)
        out[key + ".conv_block.res_conv1x1.weight"], out[key + ".conv_block.res_conv1x1.bias"] = (c, 2 * c, 1, 1), (c,)
        for j, cin in ((0, 2 * c), (3, c)):
            out[key + ".conv_block.block.{}.weight".format(j)] = (c, cin, 3, 3)
            out[key + ".conv_block.block.{}.bias".format(j)] = (c,)
            bn(key + ".conv_block.block.{}".format(j + 2), c)
        c_in = c
    n, lands = cfg["num_classes"], cfg["num_lands"]
    out["seg_conv.weight"] = (n, c_in, 1, 1)
    out["lands_1x1.0.weight"], out["lands_1x1.1.weight"] = (lands + n, c_in + n, 1, 1), (lands, lands + n, 1, 1)
    return out


def state(seed=3, dtype=torch.float64):
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in weights.make_state(shapes(CFG), seed, "cpu").items()}


def test_float32_and_float64_forwards_agree_and_repeat():
    x = torch.randn(2, 1, 36, 36, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    p64 = state()
    seg64, h64 = unet.forward(p64, x, CFG, F64, train=True)
    again, _ = unet.forward(p64, x, CFG, F64, train=True)
    assert torch.equal(seg64, again)
    seg32, h32 = unet.forward(state(dtype=torch.float32), x.float(), CFG, unet.Numerics(torch.float32), train=True)
    assert seg64.shape == (2, CFG["num_classes"], 36, 36) and h64.shape == (2, CFG["num_lands"], 36, 36)
    assert (seg32.double() - seg64).abs().max() < 1e-5
    assert (h32.double() - h64).abs().max() < 1e-4 * h64.abs().max()


def test_loss_gradient_matches_finite_differences():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 1, 36, 36, dtype=torch.float64, generator=gen)
    tgt = torch.nn.functional.one_hot(torch.randint(0, 7, (2, 32, 32), generator=gen), 7).permute(0, 3, 1, 2).double()
    heats = torch.rand(2, CFG["num_lands"], 32, 32, dtype=torch.float64, generator=gen)
    p = state()
    key = "down_path.1.block.3.weight"
    w = p[key].clone().requires_grad_(True)

    def loss(wk):
        seg, h = unet.forward({**p, key: wk}, x, CFG, F64, train=True)
        return ref_train.joint_loss(seg, h, tgt, heats, 0.5)

    (g,) = torch.autograd.grad(loss(w), w)
    # a seeded direction: a random one can cross a ReLU's kink within eps
    d = torch.randn(tuple(w.shape), dtype=torch.float64, generator=gen)
    eps = 1e-6
    with torch.no_grad():
        fd = (loss(w + eps * d) - loss(w - eps * d)) / (2 * eps)
    assert abs(float(fd) - float((g * d).sum())) < 1e-6 * max(1.0, abs(float(fd)))


def test_sgd_matches_torch_sgd():
    p = {"a": torch.randn(5, dtype=torch.float64), "b": torch.randn(3, dtype=torch.float64)}
    ref = ref_train.SGD(0.9, True, 1e-4)
    params = [torch.nn.Parameter(p[k].clone()) for k in p]
    opt = torch.optim.SGD(params, lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-4)
    mine = {k: v.clone() for k, v in p.items()}
    for step in range(3):
        grads = {k: torch.randn_like(v) for k, v in p.items()}
        ref.step(mine, grads, 0.1)
        for q, k in zip(params, p):
            q.grad = grads[k].clone()
        opt.step()
        for q, k in zip(params, p):
            assert torch.allclose(q.detach(), mine[k], rtol=0, atol=1e-15)


def test_prepare_without_augmentation_pads_and_normalizes():
    g = torch.Generator().manual_seed(2)
    projs = torch.rand(2, 32, 32, generator=g)
    segs = torch.randint(0, 7, (2, 32, 32), generator=g).to(torch.uint8)
    lands = torch.tensor([[[10.0, math.inf], [12.0, math.inf]]] * 2)
    draws = {"aug": torch.zeros(2, dtype=torch.bool), "invert": torch.zeros(2, dtype=torch.bool),
             "sigma": torch.zeros(2), "noise": torch.zeros(2, 32, 32), "gamma": torch.ones(2),
             "rot": torch.zeros(2), "trans": torch.zeros(2, 2), "shear": torch.zeros(2, 2), "scale": torch.ones(2),
             "erase": torch.zeros(2, dtype=torch.bool), "num_boxes": torch.ones(2, dtype=torch.long),
             "box_normal": torch.zeros(2, 5, 2), "box_uniform": torch.zeros(2, 5, 2), "box_noise": torch.zeros(2, 5, 36, 36)}
    x, onehot, heats = ref_train.prepare(draws, projs, segs, lands, 7, 36)
    assert x.shape == (2, 1, 36, 36)
    assert torch.allclose(x.mean(dim=(2, 3)), torch.zeros(2, 1), atol=1e-5)
    assert torch.equal(onehot.argmax(dim=1), segs.long())
    assert heats[:, 1].abs().max() == 0 and int(heats[0, 0].flatten().argmax()) == 12 * 32 + 10
    # an identity warp of the augmented branch repeats the frame
    same = ref_train.warp(projs, ref_train.inverse_affine((16.0, 16.0), torch.zeros(2), (torch.zeros(2),) * 2,
                                                          torch.ones(2), (torch.zeros(2),) * 2), 1, (32, 32), 0.0)
    assert torch.allclose(same, projs, atol=1e-5)


def test_resize_and_landmark_decode():
    m = ref_infer.resize_matrix(48, 24)
    assert np.allclose(m.sum(axis=1), 1.0) and m.shape == (24, 48)
    heats = np.zeros((2, 30, 30))
    heats[0] = ref_infer.gaussian(30)
    heats[0] = np.roll(np.roll(heats[0], 3, 0), -4, 1)
    labels = np.zeros((30, 30), np.uint8)
    labels[10:25, 5:20] = 5  # FH-l's structure
    rows, cols, nccs = ref_infer.landmarks(heats, labels, ["FH-l", "ASIS-r"])
    assert (rows[0], cols[0]) == (18, 11) and nccs[0] > 0.99
    assert rows[1] == -1 and np.isnan(nccs[1])
