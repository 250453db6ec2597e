"""The port's depth-CNN training (`densemonoslam_tpu_torch.models.depthnet`:
`l1_depth_loss`, `make_train_step`, flax's initialisation, weight files)
against the JAX package's, on the tiny net of `tests/test_depthnet.py`
(widths (8, 16, 24)) at 48x64.  Every check starts from the JAX
`net.init(PRNGKey(0))` parameters carried across by `params_from_flax`, and
draws its inputs from `numpy.random.default_rng`."""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from densemonoslam_tpu.models import depthnet as jdn
from densemonoslam_tpu_torch.config import CameraConfig, CameraIntrinsics, FrameResolution
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.models import depthnet as tdn

torch.set_num_threads(2)

WIDTHS, MIN_D, MAX_D = (8, 16, 24), 0.3, 10.0
H, W, B = 48, 64, 4


def _flat(tree) -> dict:
    """A flax parameter tree as '/' paths -> numpy, the layout of the npz files."""
    return {"/".join(str(k.key) for k in ks): np.array(v)
            for ks, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jnet():
    return jdn.DepthNet(widths=WIDTHS, min_depth=MIN_D, max_depth=MAX_D)


@pytest.fixture(scope="module")
def init(jnet):
    """The JAX initial parameters: (flax tree, the port's `DepthNet` holding them)."""
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), x)["params"]
    return params, _torch_net(params)


def _torch_net(params) -> tdn.DepthNet:
    net = tdn.DepthNet(WIDTHS, MIN_D, MAX_D)
    net.load_state_dict(tdn.params_from_flax(_flat(params)))
    return net


def _batch(seed: int = 0):
    """RGB [B, H, W, 3] in [0, 1] and depth [B, H, W] in [MIN_D, MAX_D] with
    about a tenth of the pixels 0 (no measurement)."""
    gen = np.random.default_rng(seed)
    rgb = gen.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    depth = gen.uniform(MIN_D, MAX_D, (B, H, W)).astype(np.float32)
    depth[gen.uniform(size=depth.shape) < 0.1] = 0.0
    return rgb, depth


# the output width of each block, in flax's creation order (`DepthNet`)
WIDTHS_OF_BLOCK = [w for w in WIDTHS for _ in (0, 1)] + [WIDTHS[-1]] + list(reversed(WIDTHS))


def _gn_cancelled(name: str) -> bool:
    """A conv bias whose GroupNorm has one channel per group (min(8,
    features) groups): the norm subtracts it again, so its true gradient is
    0 and both packages return f32 noise that no relative norm can compare."""
    parts = name.split(".")
    return (parts[0] == "blocks" and parts[2:] == ["conv", "bias"]
            and WIDTHS_OF_BLOCK[int(parts[1])] <= 8)


def test_l1_depth_loss_matches_reference():
    """Value and gradient with respect to `pred` against
    `jax.value_and_grad` of the JAX loss, with zeros in `gt`, within 1e-6
    relative."""
    pred = np.random.default_rng(1).uniform(MIN_D, MAX_D, (B, H, W)).astype(np.float32)
    _, gt = _batch(2)
    jl, jg = jax.jit(jax.value_and_grad(jdn.l1_depth_loss))(jnp.asarray(pred), jnp.asarray(gt))
    tp = torch.from_numpy(pred).requires_grad_()
    tl = tdn.l1_depth_loss(tp, torch.from_numpy(gt))
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-6 * abs(float(jl))
    assert _rel(tp.grad.numpy(), jg) <= 1e-6


def test_loss_and_gradients_through_the_net(jnet, init):
    """The loss of the whole net on one batch within 1e-5 relative, and
    every parameter's gradient within 1e-4 relative norm (the conv biases
    that a one-channel-per-group GroupNorm cancels: both below 1e-5 of their
    conv kernel's gradient)."""
    params, net = init
    rgb, gt = _batch(3)

    def loss_fn(p):
        return jdn.l1_depth_loss(jnet.apply({"params": p}, jnp.asarray(rgb)), jnp.asarray(gt))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    jg = tdn.params_from_flax(_flat(jg))
    tl = tdn.l1_depth_loss(net(torch.from_numpy(rgb).permute(0, 3, 1, 2)), torch.from_numpy(gt))
    net.zero_grad()
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    worst = {}
    for name, p in net.named_parameters():
        if _gn_cancelled(name):
            kernel = np.linalg.norm(jg[name.replace("bias", "weight")].numpy())
            assert np.linalg.norm(p.grad.numpy()) < 1e-5 * kernel, name
            assert np.linalg.norm(jg[name].numpy()) < 1e-5 * kernel, name
            continue
        worst[name] = _rel(p.grad.numpy(), jg[name].numpy())
    assert max(worst.values()) <= 1e-4, worst


def test_adam_matches_optax(init):
    """The same gradient arrays fed to `optax.adam(3e-3)` and to the port's
    `torch.optim.Adam(3e-3, betas=(0.9, 0.999), eps=1e-8)` for 3 steps: the
    parameters agree within 1e-6 relative norm, all together, and each
    within 1e-5.  optax forms the bias corrections 1 - beta**t in f32, where
    1 - 0.999 is 1.3e-5 off, which moves every update by 6.4e-6 relative:
    a bias that starts at 0 is nothing but its 3 updates."""
    params, net = init
    net = _torch_net(params)
    gen = np.random.default_rng(4)
    grads = [jax.tree.map(lambda v: gen.normal(0, 1, v.shape).astype(np.float32), params)
             for _ in range(3)]
    opt = optax.adam(3e-3)
    state = opt.init(params)

    @jax.jit
    def update(g, st, p):
        u, st = opt.update(g, st, p)
        return optax.apply_updates(p, u), st

    topt = torch.optim.Adam(net.parameters(), lr=3e-3, betas=(0.9, 0.999), eps=1e-8)
    tparams = dict(net.named_parameters())
    for g in grads:
        params, state = update(g, state, params)
        for name, v in tdn.params_from_flax(_flat(g)).items():
            tparams[name].grad = v.clone()
        topt.step()
    ref = tdn.params_from_flax(_flat(params))
    for name, v in ref.items():
        assert _rel(tparams[name].detach().numpy(), v.numpy()) <= 1e-5, name
    flat = lambda d: np.concatenate([v.detach().numpy().ravel() for v in d.values()])  # noqa: E731
    assert _rel(flat({k: tparams[k] for k in ref}), flat(ref)) <= 1e-6


def test_train_steps_match_reference(jnet, init):
    """5 `make_train_step` steps on one batch, Adam 3e-3 in both packages:
    the losses agree within 1e-3 relative (Adam's first update is about
    lr * sign(g), so parameters whose gradient is at f32 noise may move
    apart by 2 lr; the losses do not)."""
    params, _ = init
    net = _torch_net(params)
    rgb, gt = _batch(5)
    opt = optax.adam(3e-3)
    jstep = jdn.make_train_step(jnet, opt)
    state = opt.init(params)
    step = tdn.make_train_step(net, torch.optim.Adam(net.parameters(), lr=3e-3))
    jl, tl = [], []
    for _ in range(5):
        params, state, loss = jstep(params, state, jnp.asarray(rgb), jnp.asarray(gt))
        jl.append(float(loss))
        out = step(torch.from_numpy(rgb), torch.from_numpy(gt))
        assert out.dim() == 0 and not out.requires_grad
        tl.append(float(out))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


def test_initialisation_like_flax():
    """flax's initialisation: per conv, the kernel's std within 10% of
    sqrt(1/fan_in) and no value beyond the +-2 sigma cut, biases 0,
    GroupNorm scale 1 and bias 0; the same seed gives the same net."""
    net = tdn.DepthNet(WIDTHS, MIN_D, MAX_D, seed=0)
    n_conv = 0
    for name, p in net.named_parameters():
        v = p.detach().numpy()
        if name.endswith("conv.weight") or name == "head.weight":
            n_conv += 1
            std = np.sqrt(1.0 / v[0].size)
            assert abs(v.std() / std - 1.0) < 0.10, (name, v.std(), std)
            assert np.abs(v).max() <= 2.0 * std / 0.87962566103423978 + 1e-7, name
        elif name.endswith("norm.weight"):
            assert np.all(v == 1.0), name
        else:
            assert np.all(v == 0.0), name
    assert n_conv == 2 * len(WIDTHS) + 1 + len(WIDTHS) + 1
    again = tdn.DepthNet(WIDTHS, MIN_D, MAX_D, seed=0).state_dict()
    other = tdn.DepthNet(WIDTHS, MIN_D, MAX_D, seed=1).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in net.state_dict().items())
    assert not torch.equal(net.blocks[0].conv.weight, other["blocks.0.conv.weight"])


def test_training_learns_synthetic_depth(init):
    """The mirror of `tests/test_depthnet.py::test_training_learns_synthetic_depth`:
    400 steps of Adam 3e-3 on 8 views of the tiny scene cut the loss below
    half of step 0's, and the fitted view's error ends below the mean-depth
    baseline."""
    cam = CameraConfig(FrameResolution(W, H), CameraIntrinsics(52.0, 52.0, 31.5, 23.5), "tiny")
    seq = SyntheticSequence(camera=cam, num_frames=12, radius=0.3, max_angle=0.25)
    frames = [seq.frame(i) for i in range(8)]
    rgb = torch.from_numpy(np.stack([f[0] for f in frames]).astype(np.float32) / 255.0)
    gt = torch.from_numpy(np.stack([f[1] for f in frames]))
    net = _torch_net(init[0])
    step = tdn.make_train_step(net, torch.optim.Adam(net.parameters(), lr=3e-3))
    losses = [float(step(rgb, gt)) for _ in range(400)]
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    rgb0, depth0 = frames[0]
    with torch.no_grad():
        pred = net(torch.from_numpy(rgb0[None].astype(np.float32) / 255.0).permute(0, 3, 1, 2))[0]
    err = float(np.mean(np.abs(pred.numpy() - depth0)))
    base = float(np.mean(np.abs(depth0.mean() - depth0)))
    assert err < base, (err, base)


def test_weights_cross_both_ways(tmp_path, init):
    """A file the port writes (`DepthPredictor.save`, the JAX keys) loads
    into the JAX `DepthPredictor.load` and predicts within 1e-4 relative of
    the port; a file the JAX package writes loads into the port the same."""
    rgb = np.random.default_rng(6).integers(0, 256, (H, W, 3)).astype(np.uint8)
    port = tdn.DepthPredictor(widths=WIDTHS, min_depth=MIN_D, max_depth=MAX_D, seed=3,
                              device="cpu")
    port.save(str(tmp_path / "port.npz"))
    jax_side = jdn.DepthPredictor(widths=WIDTHS, min_depth=MIN_D, max_depth=MAX_D)
    jax_side.load(str(tmp_path / "port.npz"), H, W)
    np.testing.assert_allclose(np.asarray(jax_side.predict(jnp.asarray(rgb))),
                               port.predict(rgb).numpy(), rtol=1e-4)

    jax_saved = jdn.DepthPredictor(widths=WIDTHS, min_depth=MIN_D, max_depth=MAX_D, seed=5)
    jax_saved.init_for(H, W)
    jax_saved.save(str(tmp_path / "jax.npz"))
    port.load(str(tmp_path / "jax.npz"))
    np.testing.assert_allclose(port.predict(rgb).numpy(),
                               np.asarray(jax_saved.predict(jnp.asarray(rgb))), rtol=1e-4)


@pytest.mark.parametrize("name", ["synthetic", "street"])
def test_packaged_weights_are_the_port_own_copies(name):
    """`WEIGHTS_DIR` lies inside the port's package, and its files are
    byte-equal copies of the JAX package's."""
    import densemonoslam_tpu.models
    import densemonoslam_tpu_torch

    port_root = tdn.Path(densemonoslam_tpu_torch.__file__).resolve().parent
    assert tdn.WEIGHTS_DIR.resolve().is_relative_to(port_root)
    jax_dir = tdn.Path(densemonoslam_tpu.models.__file__).resolve().parent / "weights"
    for ext in ("npz", "json"):
        f = f"depthnet_{name}.{ext}"
        assert filecmp.cmp(tdn.WEIGHTS_DIR / f, jax_dir / f, shallow=False), f
