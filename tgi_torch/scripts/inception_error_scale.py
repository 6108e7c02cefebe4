"""How far a correct float32 Inception-v3 stands from its float64 run, and
how far the faults that a card-vs-CPU check must catch move it.

    python -m tgi_torch.scripts.inception_error_scale [--device cuda]
        [--seeds 0 1 2]

Per seed: drawn weights (``inception_v3_init`` and a 1000-way head of
N(0, 0.01²)), every BatchNorm's statistics calibrated on 16 smooth
images at 512² and their clamped copies (``calibrate_inception``), then
4 other images through the antialiased resize to 299². Read, as max
|Δ| / max |reference| over features and logits, in torchvision's layout
and in TF's (``tf_layout``):

  fp32_vs_fp64      float32 on ``--device`` against float64 on the CPU
  cpu_fp32_vs_fp64  float32 on the CPU against float64 on the CPU
  device_vs_cpu     float32 on ``--device`` against float32 on the CPU
                    (what ``chip_smoke.py`` phase 15a bounds)
  order_spread      float32 on ``--device`` under a second summation
                    order (cuDNN's autotuned algorithms on a card,
                    oneDNN off on the CPU) against the first

and once, in float64 on the CPU, the same measure for a fault each:
the pad counted in the average pools, BatchNorm's eps 1.1e-3 for 1e-3,
the resize without antialiasing, and TF32 convolutions (inputs and
weights rounded to 10 mantissa bits). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch
import torch.nn.functional as F

from tgi_torch.metrics import inception as ti


def bn_stats(bn, y):
    """BatchNorm params whose running statistics are those of ``y``
    ([N, C, H, W] or [N, C])."""
    dims = (0, 2, 3) if y.dim() == 4 else (0,)
    return {**bn, "running_mean": y.mean(dim=dims),
            "running_var": y.var(dim=dims, unbiased=False).clamp(min=1e-5)}


def calibrate_inception(params, x, tf_layout=False):
    """Every BatchNorm's running statistics set, in place, from the
    activations the batch ``x`` gives it (the O(1) operating point of a
    trained net; with identity statistics a drawn Inception's features
    fall to ~1e-6 and two runs cannot be compared)."""
    plain_bn = ti._bn

    def bn(p, y, eps=ti.BN_EPS):
        p.update(bn_stats(p, y))
        return plain_bn(p, y, eps)

    ti._bn = bn
    try:
        with torch.no_grad():
            ti.inception_v3_features(params, x, tf_layout=tf_layout)
    finally:
        ti._bn = plain_bn
    return params


def _cast(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def _tf32(x):
    """float32 rounded to TF32's 10 mantissa bits, back in x's dtype."""
    v = x.float().view(torch.int32)
    return ((v + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)


def _outputs(params, x, tf_layout, dtype, device):
    q = _cast(params, dtype, device)
    with torch.no_grad():
        f = ti.inception_v3_features(q, x.to(device=device, dtype=dtype),
                                     tf_layout=tf_layout)
        logits = f @ q["fc"]["weight"].T + q["fc"]["bias"]
    return [f.double().cpu(), logits.double().cpu()]


def _rel(got, want):
    return max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(got, want))


@contextlib.contextmanager
def _patched(name, fn):
    plain = getattr(ti, name)
    setattr(ti, name, fn)
    try:
        yield
    finally:
        setattr(ti, name, plain)


def _second_order(device):
    if device == "cpu":
        return torch.backends.mkldnn.flags(enabled=False)
    return torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                      deterministic=False, allow_tf32=False)


def _setup(seed):
    g = torch.Generator().manual_seed(seed)
    low = torch.randn(20, 3, 16, 16, generator=g)
    img = F.interpolate(low, size=512, mode="bicubic",
                        align_corners=False) * 0.6
    params = ti.inception_v3_init(g, "cpu")
    params["fc"] = {"weight": torch.randn(1000, 2048, generator=g) * 0.01,
                    "bias": torch.randn(1000, generator=g) * 0.01}
    calib = torch.cat([img[:16], img[:16].clamp(-1, 1)])
    return params, ti.resize_299(calib), img[16:]


def seed_errors(seed, device):
    out = {}
    for layout, tf_layout in (("torchvision", False), ("tf", True)):
        params, calib, img = _setup(seed)
        calibrate_inception(params, calib, tf_layout)
        x = ti.resize_299(img)
        ref = _outputs(params, x, tf_layout, torch.float64, "cpu")
        cpu = _outputs(params, x, tf_layout, torch.float32, "cpu")
        dev = _outputs(params, x, tf_layout, torch.float32, device)
        with _second_order(device):
            dev2 = _outputs(params, x, tf_layout, torch.float32, device)
        out[layout] = {"fp32_vs_fp64": _rel(dev, ref),
                       "cpu_fp32_vs_fp64": _rel(cpu, ref),
                       "device_vs_cpu": _rel(dev, cpu),
                       "order_spread": _rel(dev2, dev)}
    return out


def fault_errors(seed=0):
    params, calib, img = _setup(seed)
    calibrate_inception(params, calib)
    x = ti.resize_299(img)

    def run(xx=x):
        return _outputs(params, xx, False, torch.float64, "cpu")

    ref = run()
    bn, conv = ti._bn, ti._conv
    faults = {}
    with _patched("_avgpool", lambda y, k=3, s=1, pad=1:
                  F.avg_pool2d(y, k, s, pad)):
        faults["pad_counted_in_avgpool"] = _rel(run(), ref)
    with _patched("_bn", lambda p, y, eps=ti.BN_EPS: bn(p, y, 1.1e-3)):
        faults["bn_eps_1.1e-3"] = _rel(run(), ref)
    faults["resize_not_antialiased"] = _rel(
        run(ti.bilinear_resize(img, 299, antialias=False)), ref)
    with _patched("_conv", lambda y, w, stride=1, padding=(0, 0):
                  conv(_tf32(y), _tf32(w), stride, padding)):
        faults["tf32_convolutions"] = _rel(run(), ref)
    return faults


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"device": args.device,
           "seeds": {s: seed_errors(s, args.device) for s in args.seeds},
           "faults_fp64_cpu": fault_errors()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
