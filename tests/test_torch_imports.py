"""tgi_torch and chip_smoke.py stand alone: no jax, no ml_dtypes, no tgi,
and no click, PIL, imageio, scipy, tensorboard or wandb at module level
(the card's machine may have none of them)."""

import ast
import os
import subprocess
import sys

import pytest

# Imported only inside the functions that use them.
OPTIONAL = {"click", "PIL", "imageio", "scipy", "tensorboard", "wandb"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tgi_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        if rel != "chip_smoke":
            mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                        else rel)
    return mods


def _imports(node):
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module.split(".")[0]]
    return []


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    tree = ast.parse(open(path).read(), path)
    anywhere = {m for n in ast.walk(tree) for m in _imports(n)}
    assert not anywhere & {"jax", "jaxlib", "ml_dtypes", "tgi"}, anywhere
    top = {m for n in tree.body for m in _imports(n)}
    assert not top & OPTIONAL, top


def test_import_without_jax_or_tgi():
    """Import every module of the port, and chip_smoke up to its main,
    with jax and tgi made unimportable."""
    code = (
        "import sys\n"
        f"for name in ('jax', 'jaxlib', 'ml_dtypes', 'tgi', "
        f"*{sorted(OPTIONAL)!r}):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert callable(chip_smoke.main)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_scan_covers_the_stage2_modules():
    """The scans above reach every module of the stage-2 slice."""
    assert {"tgi_torch.apps.run_pti", "tgi_torch.invert.coach",
            "tgi_torch.io.checkpoints", "tgi_torch.losses.basic",
            "tgi_torch.losses.lpips", "tgi_torch.losses.warp",
            "tgi_torch.models.alexnet", "tgi_torch.utils.image",
            "tgi_torch.io.pickle_import", "tgi_torch.io.validate"} <= set(
                _modules())


def test_scan_covers_the_output_modules():
    """The scans above reach every module of the outputs slice (videos,
    meshes, the locality regulariser, snapshots, GANSpace)."""
    assert {"tgi_torch.apps.gen_videos", "tgi_torch.apps.shape",
            "tgi_torch.apps.ganspace", "tgi_torch.losses.locality",
            "tgi_torch.utils.marching", "tgi_torch.utils.native_build",
            "tgi_torch.utils.opt_viz"} <= set(_modules())


def test_scan_covers_the_gate_modules():
    """The scans above reach every module of the e4e / --eval / gate
    slice."""
    assert {"tgi_torch.models.irse", "tgi_torch.models.e4e",
            "tgi_torch.models.arcface", "tgi_torch.losses.id_loss",
            "tgi_torch.metrics", "tgi_torch.metrics.msssim",
            "tgi_torch.apps.pose_pipeline", "tgi_torch.invert",
            "tgi_torch.invert.bootstrap", "tgi_torch.invert.selfinv",
            "tgi_torch.scripts.selfinv_gate",
            "tgi_torch.scripts.selfinv_probe"} <= set(_modules())


def test_scan_covers_the_training_modules():
    """The scans above reach every module of the GAN-training slice."""
    assert {"tgi_torch.train", "tgi_torch.train.gan",
            "tgi_torch.train.loop", "tgi_torch.train.augment",
            "tgi_torch.train.dataset", "tgi_torch.nn.discriminator",
            "tgi_torch.utils.stats", "tgi_torch.utils.profiling",
            "tgi_torch.utils.draws", "tgi_torch.apps.train_gan"} <= set(
                _modules())


def test_scan_covers_the_metric_modules():
    """The scans above reach every module of the metrics slice (FID, KID,
    PR, IS, PPL, Inception, EQ and the alias-free generator)."""
    assert {"tgi_torch.metrics.gan_metrics", "tgi_torch.metrics.features",
            "tgi_torch.metrics.inception", "tgi_torch.metrics.equivariance",
            "tgi_torch.apps.calc_metrics", "tgi_torch.ops.filtered_lrelu",
            "tgi_torch.nn.synthesis3"} <= set(_modules())


def test_scan_covers_the_photo_and_tf_modules():
    """The scans above reach every module of the raw-photo and TF-pickle
    slice (landmarks, alignment, dataset_tool, the 2D StyleGAN2 and the
    TF converter)."""
    assert {"tgi_torch.utils.landmarks", "tgi_torch.utils.alignment",
            "tgi_torch.utils.summary", "tgi_torch.apps.align_data",
            "tgi_torch.apps.dataset_tool", "tgi_torch.models.stylegan2",
            "tgi_torch.io.legacy_tf", "tgi_torch.apps.legacy_convert"
            } <= set(_modules())
