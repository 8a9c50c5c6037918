"""The plain references against an independent dense forward of the
reduced nets: NHWC, convolutions as patch matmuls, BN applied after the
conv as its own step, the pruning mask put on the unfolded weights."""
import numpy as np
import pytest
import torch

from portbench._frozen.pruning import prune_balanced
from portbench.harness.check import kept_share
from portbench.harness.data import make_params
from portbench.reference import resnet50, vgg16
from portbench.reference.common import (BN_EPS, geometry, precision, prepare,
                                        schema)


def _pad_same(x, k, s):
    """NHWC zero pad by the SAME rule, worked out here from scratch."""
    h = x.shape[1]
    out = (h + s - 1) // s
    need = max(0, (out - 1) * s + k - h)
    lo = need // 2
    return torch.nn.functional.pad(x, (0, 0, lo, need - lo, lo, need - lo))


def _conv_nhwc(x, w, s):
    k = w.shape[0]
    xp = _pad_same(x, k, s)
    n, hp, wp, c = xp.shape
    ho = (hp - k) // s + 1
    cols = [xp[:, i:i + s * ho:s, j:j + s * ho:s, :]
            for i in range(k) for j in range(k)]
    pat = torch.stack(cols, dim=3).reshape(n, ho, ho, k * k * c)
    return pat @ w.reshape(k * k * c, -1)


def _masked(l, p, cfg):
    """The layer's HWIO weight with the pruning's zero pattern (found on
    the folded weight, as the rule says), but left unfolded."""
    w = p["w"].double()
    g = geometry(l, vk=cfg["vk"], vn=cfg["vn"])
    if g is None or not g.prune or cfg["weight_density"] >= 1:
        return w
    wf = p["w"].cpu().numpy()
    if l.bn:
        wf = wf * (p["scale"] / torch.sqrt(p["var"] + BN_EPS)).numpy()
    if l.op == "conv":
        _, mask = prune_balanced(wf.reshape(-1, l.cout), cfg["weight_density"],
                                 g.vk, g.vn)
        m = np.repeat(np.repeat(mask, g.vk, 0), g.vn, 1).reshape(wf.shape)
    else:
        wpad = np.pad(wf, ((0, 0), (0, g.pad)))
        _, mask = prune_balanced(wpad, cfg["weight_density"], g.vk, g.vn)
        m = np.repeat(np.repeat(mask, g.vk, 0), g.vn, 1)[:, :l.cout]
    return w * torch.from_numpy(m.astype(np.float64))


def _layer(l, p, x, cfg, res=None):
    w = _masked(l, p, cfg)
    if l.op == "conv":
        y = _conv_nhwc(x, w, l.stride)
    else:
        y = x @ w
    if l.bn:
        y = (y - p["mean"].double()) / torch.sqrt(p["var"].double() + BN_EPS)
        y = y * p["scale"].double() + p["offset"].double()
    else:
        y = y + p["b"].double()
    if res is not None:
        y = y + res
    return torch.relu(y) if l.relu else y


def _vgg_dense(layers, params, x, cfg):
    by = {l.name: l for l in layers}
    i = 1
    for c in vgg16.PLAN:
        if c == "M":
            n, h, w, ch = x.shape
            x = x.reshape(n, h // 2, 2, w // 2, 2, ch).amax(dim=(2, 4))
        else:
            x = _layer(by[f"conv{i}"], params[f"conv{i}"], x, cfg)
            i += 1
    x = x.reshape(x.shape[0], -1)
    for name in ("fc1", "fc2", "fc3"):
        x = _layer(by[name], params[name], x, cfg)
    return x


def _resnet_dense(layers, params, x, cfg):
    by = {l.name: l for l in layers}
    x = _layer(by["conv1"], params["conv1"], x, cfg)
    n, h, _, c = x.shape
    ho = (h + 1) // 2
    need = max(0, (ho - 1) * 2 + 3 - h)
    lo = need // 2
    xp = torch.full((n, h + need, h + need, c), -torch.inf,
                    dtype=x.dtype)
    xp[:, lo:lo + h, lo:lo + h] = x
    x = torch.stack([xp[:, i:i + 2 * ho:2, j:j + 2 * ho:2]
                     for i in range(3) for j in range(3)]).amax(dim=0)
    for pre, _, _, _ in resnet50._blocks():
        down = by.get(f"{pre}_down")
        sc = x if down is None else _layer(down, params[down.name], x, cfg)
        y = _layer(by[f"{pre}_conv1"], params[f"{pre}_conv1"], x, cfg)
        y = _layer(by[f"{pre}_conv2"], params[f"{pre}_conv2"], y, cfg)
        x = _layer(by[f"{pre}_conv3"], params[f"{pre}_conv3"], y, cfg,
                   res=sc)
    x = x.mean(dim=(1, 2))
    return _layer(by["fc"], params["fc"], x, cfg)


@pytest.mark.parametrize("density", [1.0, 0.235])
@pytest.mark.parametrize("net,classes,dense", [
    (vgg16, 16, _vgg_dense), (resnet50, 200, _resnet_dense)])
def test_reference_matches_an_independent_dense_forward(net, classes, dense,
                                                        density):
    cfg = {"image_size": 32, "num_classes": classes, "vk": 32, "vn": 128,
           "weight_density": density}
    layers = net.layer_table(32, classes)
    params = make_params(schema(layers), 2**31 + 11, "cpu",
                         kept=kept_share(cfg, layers))
    prep = prepare(layers, params, density, vk=32, vn=128, device="cpu")
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with precision(False), torch.inference_mode():
        got = net.forward(layers, prep, x.permute(0, 3, 1, 2).contiguous())
        want = dense(layers, params, x.double(), cfg)
    err = ((got.double() - want).abs().max(dim=1).values
           / want.abs().max(dim=1).values).max().item()
    assert err < 1e-5, err
