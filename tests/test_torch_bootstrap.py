"""The gate's self-bootstrap (``tgi_torch/invert/bootstrap.py``) against
tgi's, on the CPU, at the tiny generator (64² renders) with a small VGG
and pose net (``width_mult`` 1/8):

* ``make_pseudo_dataset`` against tgi's ``G.mapping`` / ``G.synthesis``
  on the same injected (z, yaw, pitch) draws (tgi's own
  ``make_pseudo_dataset`` compiles a ``lax.scan`` and is not called);
* ``_vgg_embed``, ``vgg_head_init``'s tree, the VGG bootstrap's loss and
  gradients against tgi's formula (the body of its
  ``train_vgg_bootstrap``, rebuilt from tgi's parts), and one step of
  ``train_vgg_bootstrap`` against that gradient plus ``optax.adam``;
* one step of ``train_pose_bootstrap`` on the uint8 dataset against
  ``pose_loss``'s gradient plus ``optax.adam``, and its validation;
* ``make_e4e_encode`` against tgi's, and ``bootstrap_aux_nets`` end to
  end at 8 images and 3 + 3 steps.

Tolerances: the dataset 1e-5 relative to its largest value; losses and
gradients 1e-4; the Adam updates through
``torch_helpers.assert_updates_match``."""

import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.apps.pose_pipeline import geodesic_rotation_loss as jgeodesic
from tgi.apps.pose_pipeline import pose_loss as jpose_loss
from tgi.invert import bootstrap as jboot
from tgi.losses.warp import area_downsample as jarea
from tgi.render import cameras as jcameras
from tgi_torch.apps.pose_pipeline import trainable
from tgi_torch.invert import bootstrap as boot
from tgi_torch.models import pose_resnet, vgg

from torch_helpers import (assert_updates_match, jit_ref, leaves_with_paths,
                           tiny_pair)

N, BATCH = 6, 4


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _rel(got, want, tol=1e-4, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)


def _tgi_batch(G, params, z, yaw_n, pitch_n):
    """The body of tgi's ``make_pseudo_dataset.render_batch`` on given
    unit-normal draws (bootstrap.py:87-102)."""
    intr = jcameras.fov_to_intrinsics(18.837)
    cond = jcameras.pack_camera(jcameras.look_at_pose(
        np.pi / 2, np.pi / 2, jnp.zeros(3), radius=2.7)[None], intr)
    yaw = np.pi / 2 + yaw_n * 0.65
    pitch = jnp.clip(np.pi / 2 + pitch_n * 0.3, 1e-5, np.pi - 1e-5)
    cams = jcameras.look_at_pose(yaw, pitch, jnp.zeros(3), radius=2.7)
    c = jcameras.pack_camera(cams, intr)
    ws = G.mapping(params, z, jnp.tile(cond, (z.shape[0], 1)),
                   truncation_psi=0.7, truncation_cutoff=14)
    img = jnp.clip(G.synthesis(params, ws, c, det=True)["image"], -1.0, 1.0)
    return (img + 1.0) * 127.5, cams, ws[:, 0, :]


@pytest.fixture(scope="module")
def setup():
    gj, pj, gt, pt = tiny_pair()
    rng = np.random.RandomState(71)
    draws = [tuple(rng.randn(*s).astype(np.float32)
                   for s in ((BATCH, 32), (BATCH,), (BATCH,)))
             for _ in range(2)]
    ds = boot.make_pseudo_dataset(
        gt, pt, num_images=N, batch=BATCH,
        draws=lambda b: tuple(torch.from_numpy(d) for d in draws[b]))
    render = jit_ref(lambda p, *d: _tgi_batch(gj, p, *d))
    want = [render(pj, *(jnp.asarray(d) for d in dr)) for dr in draws]
    want = {k: np.concatenate([np.asarray(w[i]) for w in want])[:N]
            for i, k in enumerate(("images_255", "exts", "ws"))}
    gen = torch.Generator().manual_seed(72)
    v = vgg.vgg16_init(gen, "cpu", width_mult=0.125)
    pose = pose_resnet.resnet34_init(gen, 4, "cpu", width_mult=0.125,
                                     blocks=(1, 1, 1, 1))
    return dict(gt=gt, pt=pt, ds=ds, want=want, vgg=v, pose=pose)


def test_pseudo_dataset_matches_tgi(setup):
    ds, want = setup["ds"], setup["want"]
    for k in ("images_255", "exts", "ws"):
        _rel(ds[k], want[k], 1e-5, k)
    assert ds["images_255"].shape == (N, 3, 64, 64)
    assert 0 <= float(ds["images_255"].min()) <= float(
        ds["images_255"].max()) <= 255


def test_vgg_embed_and_head_tree(setup):
    imgs = setup["ds"]["images_255"][:2]
    with torch.no_grad():
        got = boot._vgg_embed(setup["vgg"], imgs)
    want = jit_ref(jboot._vgg_embed)(_j(setup["vgg"]),
                                     jnp.asarray(imgs.numpy()))
    _rel(got, want, 1e-5, "embed")
    heads = boot.vgg_head_init(torch.Generator().manual_seed(0), device="cpu")
    want_heads = jax.eval_shape(jboot.vgg_head_init, jax.random.PRNGKey(0))
    assert ({p: tuple(t.shape) for p, t in leaves_with_paths(heads)}
            == {p: t.shape for p, t in leaves_with_paths(want_heads)})


def _tgi_vgg_loss(tr, imgs, ext, w_t):
    """tgi's ``train_vgg_bootstrap.loss_fn`` (bootstrap.py:257-278),
    rebuilt from tgi's parts."""
    acts = jboot._vgg_stage_acts(tr["vgg"], imgs)
    emb = jboot._vgg_embed(tr["vgg"], None, acts=acts)
    h = tr["heads"]
    q = emb @ h["quat"]["weight"] + h["quat"]["bias"]
    l_rot = jgeodesic(jcameras.quaternion_to_rotmat(q), ext[:, :3, :3])
    w_hat = emb @ h["w"]["weight"] + h["w"]["bias"]
    l_w = jnp.mean(jnp.square(w_hat - w_t))
    f15 = acts[15]
    rec = jax.lax.conv_general_dilated(
        f15, h["recon"]["weight"], (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW")) \
        + h["recon"]["bias"][None, :, None, None]
    tgt = jarea(imgs / 127.5 - 1.0, f15.shape[-1])
    l_rec = jnp.mean(jnp.square(rec - tgt))
    return l_rot + l_w + l_rec, {"rot": l_rot, "w": l_w, "rec": l_rec}


def test_vgg_bootstrap_loss_and_one_adam_step(setup):
    ds, lr = setup["ds"], 1e-4
    imgs_u8, exts = boot._dataset_device(ds)
    ws = ds["ws"]
    w_mu = ws.mean(dim=0, keepdim=True)
    w_sd = ws.std(unbiased=False) + 1e-8
    np.testing.assert_allclose(
        w_sd.numpy(), np.asarray(jnp.asarray(ws.numpy()).std()) + 1e-8,
        rtol=1e-6)
    ws_n = (ws - w_mu) / w_sd
    idx = torch.tensor([3, 0, 5])
    # The heads train_vgg_bootstrap draws first from its generator.
    heads = boot.vgg_head_init(torch.Generator().manual_seed(73),
                               w_dim=32, d=184, c15=32, device="cpu")
    start = {"vgg": setup["vgg"], "heads": heads}
    tr = trainable(start)
    batch = (imgs_u8[idx].float(), exts[idx], ws_n[idx])
    loss, aux = boot.vgg_bootstrap_loss(tr, *batch)
    loss.backward()
    (want, want_aux), grads = jit_ref(jax.value_and_grad(
        _tgi_vgg_loss, has_aux=True))(_j(start),
                                      *(jnp.asarray(t.numpy())
                                        for t in batch))
    _rel(loss, want, name="loss")
    for k in ("rot", "w", "rec"):
        _rel(aux[k], want_aux[k], name=k)
    g = dict(leaves_with_paths(grads))
    for path, t in leaves_with_paths(tr):
        _rel(t.grad, g[path], name=".".join(path))

    out = boot.train_vgg_bootstrap(
        setup["vgg"], ds, steps=1, lr=lr,
        generator=torch.Generator().manual_seed(73), indices=lambda s: idx)
    assert out["losses"] == [pytest.approx(float(loss.detach()), rel=1e-6)]
    opt = optax.adam(lr)
    p = _j(start)
    upd, _ = opt.update(grads, opt.init(p), p)
    assert_updates_match({"vgg": out["vgg"], "heads": out["heads"]},
                         optax.apply_updates(p, upd), p, 1, [grads], lr=lr)
    _rel(out["w_mu"], w_mu, 1e-6, "w_mu")


def test_pose_bootstrap_one_step_and_validation(setup):
    ds, lr = setup["ds"], 1e-4
    imgs_u8, exts = boot._dataset_device(ds)
    np.testing.assert_array_equal(
        imgs_u8.numpy(), np.clip(np.round(ds["images_255"].numpy()), 0,
                                 255).astype(np.uint8))
    start = pose_resnet.resnet34_calibrate(setup["pose"],
                                           ds["images_255"][:4])
    # n = 6, batch min(4, 3) = 3, n_val = min(max(3, 0), 3) = 3.
    idx = torch.tensor([4, 3, 5])
    got, val = boot.train_pose_bootstrap(start, ds, lr=lr, batch=4, steps=1,
                                         indices=lambda s: idx)
    imgs = jnp.asarray(imgs_u8.numpy().astype(np.float32))
    ext = jnp.asarray(exts.numpy())
    (loss, _), grads = jit_ref(jax.value_and_grad(
        lambda p, i, e: jpose_loss(p, i, e, "quat"), has_aux=True))(
            _j(start), imgs[idx.numpy()], ext[idx.numpy()])
    assert abs(val["losses"][0] - float(loss)) <= 1e-4 * abs(float(loss))
    opt = optax.adam(lr)
    p = _j(start)
    upd, _ = opt.update(grads, opt.init(p), p)
    p = optax.apply_updates(p, upd)
    assert_updates_match(got, p, _j(start), 1, [grads], lr=lr)

    def tgi_val(p):
        from tgi.apps.pose_pipeline import head_to_rotmat
        from tgi.models.pose_resnet import resnet34_apply
        vl, _ = jpose_loss(p, imgs[:3], ext[:3], "quat")
        rot = head_to_rotmat(resnet34_apply(p, imgs[:3]), "quat")
        tr = jnp.einsum("nij,nij->n", rot, ext[:3, :3, :3])
        return vl, jnp.degrees(jnp.arccos(jnp.clip((tr - 1) / 2, -1,
                                                    1))).mean()

    vl, vdeg = jit_ref(tgi_val)(p)
    # After an update (see test_torch_pose_pipeline): 1e-3.
    assert abs(val["val_loss"] - float(vl)) <= 1e-3 * abs(float(vl))
    assert abs(val["val_rot_deg"] - float(vdeg)) <= 1e-3 * abs(float(vdeg))


def test_make_e4e_encode_matches_tgi(setup):
    heads = boot.vgg_head_init(torch.Generator().manual_seed(74), w_dim=32,
                               d=184, c15=32, device="cpu")
    w_mu, w_sd = torch.zeros(1, 32), torch.tensor(0.7)
    t255 = setup["ds"]["images_255"][:1]
    got = boot.make_e4e_encode(setup["vgg"], heads, w_mu, w_sd)(t255)
    enc = jboot.make_e4e_encode(_j(setup["vgg"]), _j(heads),
                                jnp.asarray(w_mu.numpy()),
                                jnp.asarray(w_sd.numpy()))
    _rel(got, jit_ref(enc)(jnp.asarray(t255.numpy())), 1e-5, "e4e")
    assert got.shape == (1, 32)


def test_bootstrap_aux_nets_trains_both_nets(setup):
    logs = []
    pose, v, e4e, rep = boot.bootstrap_aux_nets(
        setup["gt"], setup["pt"], seed=5, pose_params=setup["pose"],
        vgg_params=setup["vgg"], num_images=8, pose_steps=3, vgg_steps=3,
        pose_batch=4, vgg_batch=4, log=logs.append)
    for new, old in ((pose, setup["pose"]), (v, setup["vgg"])):
        a, b = dict(leaves_with_paths(new)), dict(leaves_with_paths(old))
        assert a.keys() == b.keys()
        assert all(a[k].shape == b[k].shape for k in a)
        assert any(not torch.equal(a[k], b[k]) for k in a)
    # The caller's nets are untouched (the pose net is calibrated on a
    # copy).
    assert torch.equal(setup["pose"]["bn1"]["running_var"],
                       torch.ones_like(setup["pose"]["bn1"]["running_var"]))
    assert len(rep["pose_losses"]) == 3 and len(rep["vgg_losses"]) == 3
    assert all(math.isfinite(x) for x in rep["pose_losses"]
               + rep["vgg_losses"] + [rep["pose_val_loss"],
                                      rep["pose_val_rot_deg"]])
    delta = e4e(setup["ds"]["images_255"][:1])
    assert delta.shape == (1, 32) and torch.isfinite(delta).all()
    assert any("pseudo dataset" in line for line in logs)
