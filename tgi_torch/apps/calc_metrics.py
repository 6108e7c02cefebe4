"""GAN metric evaluation CLI (twin of ``tgi/apps/calc_metrics.py``).

Behavioral parity target: calc_metrics.py:31-190, on one device:

    python -m tgi_torch.apps.calc_metrics --network G.pkl --data DIR \\
        --detector inception.pkl --metrics fid,kid,pr --num-items 50000

The generator comes from a reference EG3D ``.pkl`` (bf16 mixed
precision, as ``tgi`` loads it) or the port's ``.pt`` / ``.ckpt``
(``run_pti.load_any_generator``); the data from an image folder or zip
(``train/dataset.py``, PNG, JPEG or ``.npy``). ``--detector`` reads
NVIDIA's Inception-2015-12-05 detector pickle (no pickled code runs), or a
``torch.save``d state dict in torchvision's ``inception_v3`` layout or in
NVIDIA's names. Without it the features are the VGG16/LPIPS embedding
(``--vgg-weights``, or random weights with a warning), averaged over
the image, which is not comparable to published numbers.

The command line computes the feature metrics (fid, kid, pr). ``is50k``
needs the detector's class probabilities and ``ppl2_wend`` an LPIPS
network and a camera sampler, which ``tgi``'s command line does not pass
(it crashes on them); this one refuses both up front. Call
``metrics.gan_metrics.calc_metric`` for them. ``click`` is imported by
:func:`main` only.
"""

from __future__ import annotations

import math

import torch

from tgi_torch import default_device

NOT_ON_THE_COMMAND_LINE = ("is50k", "ppl2_wend")


def default_camera_sampler(G=None, pivot=(0, 0, 0.2), radius=2.7,
                           fov=18.837, yaw_std=0.35, pitch_std=0.15,
                           device=None):
    """``sample(generator, n)`` -> [n, 25] packed cameras on ``device``:
    yaw and pitch normal around the frontal view, drawn from
    ``generator`` (a CPU torch.Generator)."""
    from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                          pack_camera)
    device = device or default_device()
    intr = fov_to_intrinsics(fov, device=device)
    lookat = torch.tensor(pivot, dtype=torch.float32, device=device)

    def sample(generator, n):
        yaw = math.pi / 2 + torch.randn((n,), generator=generator) * yaw_std
        pitch = (math.pi / 2
                 + torch.randn((n,), generator=generator) * pitch_std)
        cams = look_at_pose(yaw.to(device), pitch.to(device), lookat,
                            radius=radius, device=device)
        return pack_camera(cams, intr)

    return sample


def _from_unit_255(fn):
    """A detector on [0, 255] images as a feature fn on [-1, 1] ones."""
    return lambda img_unit: fn((img_unit + 1) * 127.5)


def load_detector_feature_fn(path, device=None):
    """Detector weights file -> fn(img_unit [-1,1] NCHW) -> [N, 2048].

    Accepts the reference's NVIDIA Inception-2015-12-05 detector pickle
    (metric_utils.py:44-57; TF graph names, read code-free) or a state
    dict saved with ``torch.save``, in torchvision ``inception_v3``'s
    layout or NVIDIA's names. FID/KID/PR with the NVIDIA weights are
    comparable to upstream-published values.
    """
    from tgi_torch.metrics.inception import (convert_nvidia_inception,
                                             convert_torch_inception,
                                             inception_feature_fn,
                                             nvidia_detector_fn)
    device = device or default_device()
    if path.endswith(".pkl"):
        from tgi_torch.io.pickle_import import ReferenceUnpickler
        with open(path, "rb") as f:
            obj = ReferenceUnpickler(f).load()
        return _from_unit_255(nvidia_detector_fn(
            convert_nvidia_inception(obj, device)))
    from tgi_torch.apps.run_pti import load_state_dict
    sd = load_state_dict(path)
    if any(k.startswith(("layers.", "output.")) for k in sd):
        return _from_unit_255(nvidia_detector_fn(
            convert_nvidia_inception(sd, device)))
    return inception_feature_fn(convert_torch_inception(sd, device))


def vgg_feature_fn(vgg_weights=None, seed=0, device=None):
    """The fallback detector: VGG16's LPIPS stages (unit-normalized per
    position, scaled by the LPIPS head) of [-1, 1] images, each averaged
    over the image: [N, 1472]. ``tgi`` takes the whole flat LPIPS
    embedding, whose covariance does not fit in memory at any image size
    a generator makes (1.8 TiB at 64²); the spatial mean keeps the same
    stages at a size FID can use. Weights from a torchvision vgg16 state
    dict, or drawn from ``seed``."""
    from tgi_torch.apps.run_pti import load_state_dict
    from tgi_torch.models.vgg import (convert_torch_features,
                                      lpips_head_init, lpips_stages,
                                      vgg16_init)
    device = device or default_device()
    gen = torch.Generator().manual_seed(seed)
    vgg = (convert_torch_features(load_state_dict(vgg_weights), device)
           if vgg_weights else vgg16_init(gen, device))
    head = lpips_head_init(gen, device)

    def fn(img_unit):
        return torch.cat([a.mean(dim=(2, 3)) for a in lpips_stages(
            vgg, head, (img_unit + 1) * 127.5)], dim=1)

    return fn


def calc_metrics(network, data, metrics=("fid", "kid"), num_items=1000,
                 run_dir=None, feature_fn=None, device=None, cache_tag=""):
    """The command line's work: the features of ``num_items`` dataset
    images (cached in ``run_dir`` under ``cache_tag``, which names the
    detector) and of as many renders of the generator at ``network``
    (batches of 8), then each metric's record (printed, and appended to
    ``run_dir/metric-<name>.jsonl``). Returns the records."""
    from tgi_torch.apps.run_pti import load_any_generator
    from tgi_torch.metrics.features import (compute_dataset_features,
                                            compute_generator_features)
    from tgi_torch.metrics.gan_metrics import calc_metric, report_metric
    from tgi_torch.train.dataset import ImageFolderDataset
    device = device or default_device()
    G, params = load_any_generator(network, device=device)
    dataset = ImageFolderDataset(data, resolution=G.cfg.img_resolution)
    try:
        real = compute_dataset_features(
            dataset, feature_fn, max_items=num_items, cache_dir=run_dir,
            cache_tag=cache_tag, device=device)
    finally:
        dataset.close()
    gen = compute_generator_features(
        G, params, feature_fn, default_camera_sampler(G, device=device),
        num_items=num_items)
    return [report_metric(calc_metric(m, real_stats=real, gen_stats=gen,
                                      G=G, params=params),
                          run_dir=run_dir, snapshot=network)
            for m in metrics]


def main(argv=None):
    """Command line: ``python -m tgi_torch.apps.calc_metrics --network G
    --data DIR [--detector F]``."""
    import click

    from tgi_torch.metrics.gan_metrics import list_metrics

    @click.command()
    @click.option("--network", required=True)
    @click.option("--data", required=True, help="dataset dir or zip")
    @click.option("--metrics", default="fid,kid", help="comma-separated")
    @click.option("--num-items", default=1000)
    @click.option("--run-dir", default=None)
    @click.option("--detector", default=None,
                  help="Inception detector weights: NVIDIA detector .pkl "
                       "(reference metric_utils.py:44-57), or a torch.save'd "
                       "inception_v3 state_dict (torchvision layout or "
                       "NVIDIA's names)")
    @click.option("--vgg-weights", default=None,
                  help="fallback VGG16 feature detector (non-comparable "
                       "to upstream FID; use --detector for parity)")
    @click.option("--device", default=default_device())
    def cli(network, data, metrics, num_items, run_dir, detector,
            vgg_weights, device):
        names = [m.strip() for m in metrics.split(",") if m.strip()]
        refused = [m for m in names if m in NOT_ON_THE_COMMAND_LINE]
        if refused:
            raise click.UsageError(
                f"--metrics {','.join(refused)}: is50k needs the "
                "detector's class probabilities and ppl2_wend an LPIPS "
                "network and a camera sampler; the command line computes "
                "fid, kid and pr only (call "
                "tgi_torch.metrics.gan_metrics.calc_metric for these)")
        unknown = [m for m in names if m not in list_metrics()]
        if unknown:
            raise click.UsageError(f"--metrics: unknown {unknown} "
                                   f"(known: {', '.join(list_metrics())})")
        if detector:
            feature_fn = load_detector_feature_fn(detector, device)
        else:
            if not vgg_weights:
                click.echo("WARNING: random-init VGG detector "
                           "(no --detector / --vgg-weights)")
            feature_fn = vgg_feature_fn(vgg_weights, device=device)
        # The dataset's cached features belong to this detector alone.
        calc_metrics(network, data, names, num_items, run_dir, feature_fn,
                     device, cache_tag=f"{detector}|{vgg_weights}")

    cli.main(args=argv, standalone_mode=True)


if __name__ == "__main__":
    main()
