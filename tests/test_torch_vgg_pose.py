"""Stage 1's auxiliary networks against tgi's, on the CPU: VGG16 (the
warp features, with the in-place ReLU trap, and the LPIPS embedding),
``LPIPSLoss``, and the ResNet-34 pose estimator (apply, ``pre_tanh``,
calibration, and the gradients of every leaf, BatchNorm running
statistics included). Small widths (``width_mult`` 1/8, and one block
per pose-net stage); the weights are the port's init carried to tgi as
arrays. Tolerances: 1e-5 relative to the largest magnitude per output;
gradients 1e-4 relative to each leaf's largest."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.losses.lpips import LPIPSLoss as JLPIPSLoss
from tgi.models import pose_resnet as jpose
from tgi.models import vgg as jvgg
from tgi_torch.losses.lpips import LPIPSLoss
from tgi_torch.models import pose_resnet as pose
from tgi_torch.models import vgg

from torch_helpers import TOL, close, jit_ref, leaves_with_paths


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _rel(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (name, err)


@pytest.fixture(scope="module")
def nets():
    gen = torch.Generator().manual_seed(21)
    v = vgg.vgg16_init(gen, "cpu", width_mult=0.125)
    head = vgg.lpips_head_init(gen, "cpu", width_mult=0.125)
    p = pose.resnet34_init(gen, 4, "cpu", width_mult=0.125,
                           blocks=(1, 1, 1, 1))
    rng = np.random.RandomState(22)
    imgs = (rng.rand(2, 3, 64, 64) * 255).astype(np.float32)
    # A calibrated pose net: O(1) activations, as a trained one has.
    p = pose.resnet34_calibrate(p, torch.from_numpy(imgs[:1]))
    return dict(v=v, head=head, pose=p, imgs=imgs)


def test_init_shapes_match_tgi(nets):
    """The port's init has tgi's names and shapes at full width and at
    the scaled widths."""
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    shapes = jax.eval_shape
    for port, ref in ((vgg.vgg16_init(gen, "cpu"),
                       shapes(jvgg.vgg16_init, key)),
                      (nets["head"], shapes(
                          lambda k: jvgg.lpips_head_init(k, 0.125), key)),
                      (pose.resnet34_init(gen, 6, "cpu"),
                       shapes(lambda k: jpose.resnet34_init(k, 6), key)),
                      (nets["pose"], shapes(lambda k: jpose.resnet34_init(
                          k, 4, 0.125, blocks=(1, 1, 1, 1)), key))):
        want = {p: tuple(t.shape) for p, t in leaves_with_paths(ref)}
        assert {p: tuple(t.shape) for p, t in leaves_with_paths(port)} == want


def test_warping_features_are_post_relu(nets):
    """The reference's 'pre-ReLU' conv14 output is overwritten by the
    in-place ReLU at layer 15: both packages return the post-ReLU value."""
    x = nets["imgs"] / 127.5 - 1.0
    got = vgg.warping_features(nets["v"], torch.from_numpy(x))
    close(got, jvgg.warping_features(_j(nets["v"]), jnp.asarray(x)), TOL)
    assert got.min() >= 0 and got.shape == (2, 32, 16, 16)
    pre = vgg.vgg16_features(nets["v"], torch.from_numpy(x), outputs=(14,))
    assert torch.equal(got, torch.relu(pre[14]))
    assert (pre[14] < 0).any()


def test_lpips_features_and_distance(nets):
    a, b = nets["imgs"][:1], nets["imgs"][1:]
    close(vgg.lpips_features(nets["v"], nets["head"], torch.from_numpy(a)),
          jvgg.lpips_features(_j(nets["v"]), _j(nets["head"]),
                              jnp.asarray(a)), TOL)
    lt = LPIPSLoss(nets["v"], nets["head"])
    lj = JLPIPSLoss(_j(nets["v"]), _j(nets["head"]))
    _rel(lt(torch.from_numpy(a), torch.from_numpy(b)), lj(a, b), TOL)
    ua, ub = a / 127.5 - 1, b / 127.5 - 1
    _rel(lt.from_unit(torch.from_numpy(ua), torch.from_numpy(ub)),
         lj.from_unit(ua, ub), TOL)
    _rel(lt.features(torch.from_numpy(a)), lj.features(a), TOL)


def test_vgg_converters(nets):
    """torchvision and lpips-package state dict names -> the trees."""
    sd = {f"features.{i}.{k}": t for i, p in nets["v"]["features"].items()
          for k, t in p.items()}
    sd.update({f"lin{i}.model.1.weight": nets["head"][f"lin{i}"][
        "weight"].reshape(-1, 1, 1, 1) for i in range(5)})
    sd["classifier.0.weight"] = torch.zeros(2, 2)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    for conv, ref in ((vgg.convert_torch_features,
                       jvgg.convert_torch_features),
                      (vgg.convert_lpips_head, jvgg.convert_lpips_head)):
        got, want = conv(sd), ref(np_sd)
        assert jax.tree.structure(_j(got)) == jax.tree.structure(want)
        for (_, g), (_, w) in zip(sorted(leaves_with_paths(got)),
                                  sorted(leaves_with_paths(want))):
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pre_tanh", [False, True])
def test_resnet34_apply(nets, pre_tanh):
    x = nets["imgs"]
    got = pose.resnet34_apply(nets["pose"], torch.from_numpy(x), pre_tanh)
    want = jpose.resnet34_apply(_j(nets["pose"]), jnp.asarray(x), pre_tanh)
    _rel(got, want, TOL)
    assert got.shape == (2, 4)


def test_resnet34_calibrate():
    gen = torch.Generator().manual_seed(23)
    p = pose.resnet34_init(gen, 6, "cpu", width_mult=0.125,
                           blocks=(2, 1, 1, 1))
    x = (np.random.RandomState(24).rand(2, 3, 48, 48) * 255).astype(
        np.float32)
    got = pose.resnet34_calibrate(p, torch.from_numpy(x))
    want = jpose.resnet34_calibrate(_j(p), jnp.asarray(x))
    want = dict(leaves_with_paths(want))
    for path, t in leaves_with_paths(got):
        _rel(t, want[path], TOL, path)
    # The input's own params are left as they were.
    assert torch.equal(p["bn1"]["running_var"], torch.ones_like(
        p["bn1"]["running_var"]))


def test_resnet34_gradients_reach_the_running_statistics(nets):
    """Every leaf's gradient of a scalar of the head's output, against
    ``jax.grad``; BatchNorm's running statistics enter the forward
    through its formula and get gradients in both packages."""
    x = nets["imgs"][:1]
    ct = np.random.RandomState(25).randn(1, 4).astype(np.float32)
    want = jit_ref(jax.grad(lambda p: jnp.sum(
        jpose.resnet34_apply(p, jnp.asarray(x)) * ct)))(_j(nets["pose"]))
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                          nets["pose"])
    (pose.resnet34_apply(params, torch.from_numpy(x))
     * torch.from_numpy(ct)).sum().backward()
    want = dict(leaves_with_paths(want))
    for path, t in leaves_with_paths(params):
        _rel(t.grad, want[path], 1e-4, path)
    assert params["bn1"]["running_mean"].grad.abs().max() > 0
    assert params["layer2"]["0"]["bn2"]["running_var"].grad.abs().max() > 0


def test_convert_pose_state_dict(nets):
    sd = {".".join(p): t for p, t in leaves_with_paths(nets["pose"])}
    sd["bn1.num_batches_tracked"] = torch.tensor(3)
    got = pose.convert_torch_state_dict(sd)
    want = jpose.convert_torch_state_dict({k: v.numpy()
                                           for k, v in sd.items()})
    want = dict(leaves_with_paths(want))
    assert {p for p, _ in leaves_with_paths(got)} == set(want)
    for path, t in leaves_with_paths(got):
        assert np.array_equal(t.numpy(), np.asarray(want[path]))
