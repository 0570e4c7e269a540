"""The port's training slice against the JAX package, f32 unless stated:
losses and their gradients, the learning-rate schedules, AdamW with global-
norm clipping against optax, DropPath's law, the whole model's parameter
gradients at `TINY` against jax.grad, and three `make_train_step` steps
(grad_accum=2) against the JAX `make_train_step`.

JAX runs on the CPU with its default `attention_impl="auto"`, i.e. the XLA
forms of the attention and the LeFF; in f32 they compute what the port's
plain versions compute, in another sum order.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import TINY, flax_params_like, n, normal, rng, t

from fbanet_tpu import losses as jlosses
from fbanet_tpu import train as jtrain
from fbanet_tpu.config import TrainConfig as JaxTrainConfig
from fbanet_tpu.models import create_model as jax_create_model
from fbanet_tpu_torch import losses, train
from fbanet_tpu_torch.config import ModelConfig, TrainConfig
from fbanet_tpu_torch.models import create_model
from fbanet_tpu_torch.models.layers import DropPath
from fbanet_tpu_torch.utils.weights import (
    jax_params_to_state_dict,
    random_state_dict,
)

PORT_TINY = ModelConfig(**{f.name: getattr(TINY, f.name)
                           for f in dataclasses.fields(ModelConfig)})


def _jax_train_config(cfg: TrainConfig) -> JaxTrainConfig:
    return JaxTrainConfig(**dataclasses.asdict(cfg), donate_state=False)


# ----------------------------------------------------------------- losses ----

def _images(seed, shape=(2, 24, 20, 3)):
    """Predictions partly outside [0, 1] (the clamp matters) and targets."""
    r = rng(seed)
    return (r.uniform(-0.2, 1.2, shape).astype(np.float32),
            r.uniform(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("name", ["charbonnier_loss", "gradient_weighted_loss",
                                  "tv_loss", "fbanet_training_loss"])
def test_losses_and_gradients_match(name):
    """Value and gradient with respect to the prediction; 1e-5 relative
    (f32 means over 2880 elements in another order)."""
    pred, target = _images(1)
    jfn, tfn = getattr(jlosses, name), getattr(losses, name)
    if name == "tv_loss":
        jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred))
        p = t(pred).requires_grad_()
        val = tfn(p)
    else:
        jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred),
                                              jnp.asarray(target))
        p = t(pred).requires_grad_()
        val = tfn(p, t(target))
    val.backward()
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    np.testing.assert_allclose(n(p.grad), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-9)


def test_sobel_slice_form_matches():
    x = normal(2, (2, 3, 9, 11, 3))
    for a, b in zip(losses._sobel_gradients(t(x)),
                    jlosses._sobel_gradients(jnp.asarray(x))):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-6)


# ------------------------------------------------------- lr and optimizer ----

LR_CASES = [
    dict(warmup=True, warmup_epochs=3, nepoch=203, lr_initial=1e-4),
    dict(warmup=True, warmup_epochs=3, nepoch=4, lr_initial=1e-4),  # T = 1
    dict(warmup=False, step_lr_step=50, step_lr_gamma=0.5, lr_initial=1e-4),
    dict(warmup=True, nepoch=100, lr_initial=1e-4),
]


@pytest.mark.parametrize("case", range(len(LR_CASES)))
def test_lr_for_epoch_matches_jax(case):
    """Every epoch of the schedules tests/test_train.py pins (warmup ->
    realized cosine, StepLR, resume from a restored or the initial LR),
    exactly."""
    cfg = TrainConfig(**LR_CASES[case])
    jcfg = _jax_train_config(cfg)
    for e in range(1, cfg.nepoch + 1):
        assert train.lr_for_epoch(e, cfg) == jtrain.lr_for_epoch(e, jcfg)
        for base in (None, 2.5e-5):
            kw = dict(start_epoch=min(e, 51), resumed=True, resumed_base=base)
            assert (train.lr_for_epoch(e, cfg, **kw)
                    == jtrain.lr_for_epoch(e, jcfg, **kw))
    if case == 0:
        assert math.isclose(train.lr_for_epoch(1, cfg), 1e-4 / 3)
        assert 1e-4 < train.lr_for_epoch(4, cfg) < 1.01e-4
        assert math.isclose(train.lr_for_epoch(5, cfg), 1e-4)
        assert 1e-6 < train.lr_for_epoch(203, cfg) < 2.2e-6
    if case == 2:
        assert math.isclose(train.lr_for_epoch(50, cfg), 5e-5)


@pytest.mark.parametrize("optimizer,clip", [("adamw", 0.0), ("adamw", 0.5),
                                            ("adam", 100.0)])
def test_optimizer_and_clipping_match_optax(optimizer, clip):
    """3 steps of AdamW/Adam (betas 0.9/0.999, eps 1e-8, decoupled weight
    decay 0.02) with global-norm clipping (0.5 clips these gradients, 100
    does not) and a learning rate set per step, against optax.
    2e-7 absolute on parameters of O(1): a few f32 ulps."""
    cfg = TrainConfig(optimizer=optimizer, grad_clip_norm=clip)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: normal(i, s) for i, (k, s) in enumerate(shapes.items())}
    grads = [{k: normal(10 * s + i, v, 0.3) for i, (k, v) in
              enumerate(shapes.items())} for s in range(3)]
    lrs = [1e-2, 5e-3, 2e-3]

    tx = jtrain.make_optimizer(_jax_train_config(cfg))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    params = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
    opt = train.make_optimizer(list(params.values()), cfg)
    for g, lr in zip(grads, lrs):
        state = jtrain._set_lr(state, lr)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = t(g[k])
        if clip > 0:
            train.clip_by_global_norm_(list(params.values()), clip)
        train.set_lr(opt, lr)
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(n(params[k]), np.asarray(jp[k]),
                                       atol=2e-7, rtol=0, err_msg=k)


def test_drop_path_law():
    """One Bernoulli(keep) draw per sample: kept samples are x / keep,
    dropped ones 0; the keep rate within 5 sigma of 0.7 over 20000
    samples; the same generator seed gives the same masks; the identity in
    eval and at rate 0."""
    x = torch.ones(20000, 2, 3, 4)
    dp = DropPath(0.3)
    out = dp(x, train=True, generator=torch.Generator().manual_seed(0))
    per = out.reshape(20000, -1)
    assert torch.all(per == per[:, :1])  # one draw per sample
    vals = set(per[:, 0].tolist())
    assert vals == {0.0, float(torch.tensor(1.0) / 0.7)}
    keep = float((per[:, 0] > 0).float().mean())
    assert abs(keep - 0.7) <= 5 * math.sqrt(0.21 / 20000)
    again = dp(x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert dp(x, train=False) is x
    assert DropPath(0.0)(x, train=True) is x


def test_drop_path_schedule_matches_jax():
    """The per-layer rates: linspace over the encoder, constant in the
    bottleneck, reversed in the decoder (fbanet.py:69-72)."""
    cfg = dataclasses.replace(PORT_TINY, drop_path_rate=0.1)
    model = create_model(cfg, device="cpu")
    enc = list(np.linspace(0, 0.1, 8))
    rates = [getattr(getattr(model, f"HG1_{g}"), f"layer{i}").drop_path.rate
             for g in ("enc0", "enc1", "bottleneck", "dec0", "dec1")
             for i in range(2)]
    assert rates == pytest.approx(enc[:4] + [0.1, 0.1] + enc[::-1][:4],
                                  abs=0)


# ------------------------------------------------------------ whole model ----

def _setup(batch=2, seed=0):
    """Port model with random parameters, the flax tree holding them, a
    burst and an HR target."""
    tmodel = create_model(PORT_TINY, device="cpu", seed=3)
    sd = random_state_dict(tmodel, seed=21)
    tmodel.load_state_dict(sd, strict=True)
    r = rng(seed)
    size = TINY.img_size
    burst = r.uniform(0, 1, (batch, TINY.num_frames, size, size, 3)
                      ).astype(np.float32)
    hr = r.uniform(0, 1, (batch, 4 * size, 4 * size, 3)).astype(np.float32)
    jmodel = jax_create_model(TINY)
    params = flax_params_like(jmodel, jnp.asarray(burst), state_dict=sd)
    return tmodel, jmodel, params, burst, hr


def _assert_tensors_close(got: dict, ref: dict, rel: float, what: str):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        scale = float(np.abs(r).max())
        err = float(np.abs(got[k] - r).max())
        assert err <= rel * scale or (scale == 0 and err == 0), \
            f"{what} {k}: err {err:.3e}, max {scale:.3e}"


def test_model_gradients_match_jax_grad():
    """Every parameter gradient of the training loss (clamp, Charbonnier +
    3 GW) at TINY, drop_path 0, against jax.grad of the JAX model: within
    1e-4 of each tensor's max |grad| (the same f32 math in another sum
    order through 20 layers). Parameters the port's forward never reads
    (the FAF gate's temporal_attn0 and embedding biases, which cancel) get
    no gradient; JAX gives them exact zeros."""
    tmodel, jmodel, params, burst, hr = _setup()

    def loss(p):
        pred = jmodel.apply({"params": p}, jnp.asarray(burst))
        return jlosses.fbanet_training_loss(pred, jnp.asarray(hr))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    ref = {k: v.numpy() for k, v in jax_params_to_state_dict(
        jax.tree.map(np.asarray, jgrads)).items()}
    tloss = losses.fbanet_training_loss(
        tmodel(t(burst), train=True), t(hr))
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = {k: (n(p.grad) if p.grad is not None else np.zeros(p.shape))
           for k, p in tmodel.named_parameters()}
    unused = [k for k, p in tmodel.named_parameters() if p.grad is None]
    assert unused and all("temporal_attn" in k for k in unused)
    assert all(not ref[k].any() for k in unused)
    _assert_tensors_close(got, ref, 1e-4, "grad")


def _adam_moments(opt_state):
    """optax's ScaleByAdamState (mu, nu) inside an injected/chained state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for child in (getattr(opt_state, "inner_state", None),
                  *(opt_state if isinstance(opt_state, tuple) else ())):
        found = child is not None and _adam_moments(child)
        if found:
            return found
    return None


def test_train_steps_match_jax_make_train_step():
    """Three AdamW steps with grad_accum=2 (two microbatches of 2, lr set
    per step) through both `make_train_step`s. After every step the loss is
    within 1e-5 and every parameter within sum(lr) x 1.1, the most AdamW can
    move an element. After the first step, AdamW's first moment (a tenth of
    the microbatch-mean gradient) is within 1e-4 of each tensor's max, and
    the parameters are within 5e-6 wherever the second moment's
    sqrt(v_hat) is at least 1e-6, 100 x AdamW's eps. Below that the update
    m_hat / (sqrt(v_hat) + eps) divides a gradient of order eps, whose f32
    sum-order noise is of its own size, so such an element's step may
    differ by up to lr; the later steps start from those differences, so
    only their losses and the bound are compared."""
    tmodel, jmodel, params, burst, hr = _setup(batch=4, seed=7)
    cfg = TrainConfig(grad_accum=2, lr_initial=1e-4)
    jcfg = _jax_train_config(cfg)
    tx = jtrain.make_optimizer(jcfg)
    jstep = jtrain.make_train_step(jmodel, tx, jcfg)
    jp, state = {"params": params}, tx.init({"params": params})
    opt = train.make_optimizer(tmodel.parameters(), cfg)
    tstep = train.make_train_step(tmodel, opt, cfg)
    micro = lambda a: (a[:2], a[2:])  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    lrs = [1e-4, 8e-5, 6e-5]
    for i, lr in enumerate(lrs):
        jp, state, jloss = jstep(jp, state, tuple(map(jnp.asarray,
                                                      micro(burst))),
                                 tuple(map(jnp.asarray, micro(hr))),
                                 jax.random.key(i), lr)
        tloss = tstep(tuple(map(t, micro(burst))), tuple(map(t, micro(hr))),
                      gen, lr)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        as_torch = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                                 jax_params_to_state_dict(jax.tree.map(
                                     np.asarray, tree)).items()}
        ref = as_torch(jp)
        if i == 0:
            moments = {k: n(opt.state[p]["exp_avg"])
                       for k, p in tmodel.named_parameters()}
            _assert_tensors_close(moments, as_torch(_adam_moments(state).mu),
                                  1e-4, "first moment")
        for k, p in tmodel.named_parameters():
            err = np.abs(n(p) - ref[k])
            assert err.max() <= 1.1 * sum(lrs[:i + 1]), f"step {i} {k}"
            if i == 0:
                stable = n(opt.state[p]["exp_avg_sq"].sqrt()
                           >= 1e-6 * math.sqrt(1 - 0.999)).astype(bool)
                assert err[stable].max(initial=0) <= 5e-6, k
