"""The reference against the port's plain path at a tiny size on the CPU,
in float32: the forward, one training step (stochastic depth, loss,
gradients, AdamW) and one online registration."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import inputs, manifest, rehearse
from benchmark.kinds import train
from benchmark.reference import ecc
from benchmark.reference.model import FBANet as RefModel
from benchmark.reference.model import draw_masks
from benchmark.reference.objectives import AdamW, training_loss


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    cell = rehearse.tiny(manifest.cell("fbanet64-train-b16"))
    model = dict(cell.model, dtype="float32")
    return dataclasses.replace(cell, config=dict(cell.config, model=model))


def _port(cell, seed):
    from fbanet_tpu_torch.config import ModelConfig
    from fbanet_tpu_torch.models.fbanet import FBANet

    m = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in cell.model.items()})
    net = FBANet(m)
    net.load_state_dict(inputs.make_weights(inputs.parameter_shapes(net),
                                            seed, "cpu"))
    return net


def _ref(cell, seed):
    ref = RefModel(cell.model)
    ref.load_state_dict(inputs.make_weights(inputs.parameter_shapes(ref),
                                            seed, "cpu"))
    return ref


def _burst(cell, seed, batch=2):
    m = cell.model
    lr, hr = inputs.bursts(seed, 0, batch, m["num_frames"], m["img_size"],
                           m["in_channels"], 3.0, "cpu")
    return lr.float() / 255, hr.float() / 255


def test_same_weights_on_both_sides(tiny):
    a = inputs.make_weights(inputs.parameter_shapes(_port(tiny, 5)), 5, "cpu")
    b = inputs.make_weights(inputs.parameter_shapes(_ref(tiny, 5)), 5, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["tail_conv.weight"].abs().sum()) > 0
    assert float(a["tail_conv.bias"].abs().sum()) == 0


def test_forward_matches_the_port(tiny):
    x, _ = _burst(tiny, 3)
    with torch.no_grad():
        want = _port(tiny, 3)(x, plain=True)
        got = _ref(tiny, 3)(x)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_train_step_matches_the_port(tiny):
    from fbanet_tpu_torch.config import TrainConfig
    from fbanet_tpu_torch.train import make_optimizer, make_train_step

    seed = 2 ** 33 + 9
    x, y = _burst(tiny, seed)
    net = _port(tiny, seed)
    opt = make_optimizer(net.parameters(), TrainConfig(lr_initial=1e-4,
                                                       weight_decay=0.02))
    step = make_train_step(net, opt, TrainConfig(), plain=True)
    loss = step(x, y, train.step_generator("cpu", seed, 0, 0), 1e-4)

    ref = _ref(tiny, seed)
    ropt = AdamW(ref.parameters(), 1e-4, 0.02)
    masks = draw_masks(ref.drop_rates(), 2, train.step_generator("cpu", seed,
                                                                 0, 0))
    rloss = training_loss(ref(x, masks=masks), y)
    rloss.backward()
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    rp = dict(ref.named_parameters())
    for n, p in net.named_parameters():
        g = rp[n].grad if rp[n].grad is not None else torch.zeros_like(p)
        assert float((p.grad - g).abs().max()) <= 1e-4 * max(
            1e-6, float(g.abs().max())), n
    w0 = inputs.make_weights(inputs.parameter_shapes(ref), seed, "cpu")
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in rp.items()}
    ropt.step()
    # Adam's step is lr whatever the gradient's size: an element whose
    # gradient is round-off (a key's bias) may step the other way
    rms = sorted(float(g.norm()) / g.numel() ** 0.5 for g in grads.values())
    floor = 1e-3 * rms[len(rms) // 2]
    for n, p in net.named_parameters():
        d = (p - rp[n]).detach()
        assert float(d.abs().max()) <= 2.0001e-4, n
        moving = grads[n].abs() >= floor
        assert float(d[moving].norm()) <= 1e-2 * max(
            1e-12, float((rp[n] - w0[n]).detach()[moving].norm())), n


def test_registration_matches_the_port():
    from fbanet_tpu_torch.ops.registration import online_register

    lr, _ = inputs.bursts(11, 0, 2, 4, 64, 3, 3.0, "cpu")
    x = lr.float() / 255
    assert float((ecc.register(x) - online_register(x, "ecc")).abs().max()) \
        <= 1e-5
