"""Convert a reference network pickle into the port's checkpoint (twin of
``tgi/apps/legacy_convert.py``).

Behavioral parity target: legacy.py:295-318 (convert_network_pickle CLI).
Two input tiers, both handled in one command:

- **TF-era pickles** ((G, D, Gs) tflib tuple): re-expressed as the
  standalone 2D StyleGAN2 family via ``tgi_torch.io.legacy_tf`` — the same
  variable mapping the reference applies in convert_tf_generator /
  convert_tf_discriminator (legacy.py:109-291).
- **Modern pickles** (persistence dicts with G/D/G_ema): imported with the
  code-free unpickler and renamed into the port's trees; ``--force-fp16``
  mirrors legacy.py:48-60 (a config rewrite, no weight copying).

Output is the port's checkpoint (``tgi_torch.io.checkpoints``: tensors
plus the configs as JSON, read with ``torch.load(weights_only=True)``),
where ``tgi`` writes msgpack — the architecture lives in the stored
configs, never in embedded source. Conversion is data work: it always
runs on the CPU, as ``tgi``'s does.

Run: python -m tgi_torch.apps.legacy_convert --source net.pkl \
         --dest net.ckpt [--force-fp16 true]
"""

from __future__ import annotations

import dataclasses

from tgi_torch.io import load_network_pkl, save_checkpoint
from tgi_torch.io.legacy_tf import ConvertedSG2


def convert_pickle(source: str, dest: str, force_fp16: bool = False) -> dict:
    """Convert ``source`` (reference pickle) to a checkpoint at ``dest``
    on the CPU. Returns {name: kind} for the converted networks."""
    data = load_network_pkl(source, device="cpu")
    params, configs, kinds = {}, {}, {}
    for name in ("G", "D", "G_ema"):
        net = data.get(name)
        if net is None:
            continue
        if isinstance(net, ConvertedSG2):
            cfg = net.config
            if force_fp16 and net.kind == "generator":
                cfg = dataclasses.replace(cfg, num_fp16_res=4,
                                          conv_clamp=256,
                                          fused_dtype="bfloat16")
            params[name] = net.params
            configs[name] = {"kind": f"sg2_{net.kind}",
                             **dataclasses.asdict(cfg)}
            kinds[name] = f"sg2_{net.kind}"
        else:
            from tgi_torch.io import (captured_state_dict,
                                      convert_generator_params,
                                      generator_config_from_captured)
            if name == "D":
                continue  # EG3D D import is handled by train-resume paths
            cfg = generator_config_from_captured(net)
            if force_fp16:
                cfg = dataclasses.replace(cfg, fused_dtype="bfloat16",
                                          sr_num_fp16_res=4)
            params[name] = convert_generator_params(captured_state_dict(net),
                                                    "cpu")
            configs[name] = {"kind": "triplane_generator",
                             **dataclasses.asdict(cfg)}
            kinds[name] = "triplane_generator"
    save_checkpoint(dest, params, config=configs,
                    metadata={"source": str(source)})
    return kinds


def main(argv=None):
    """Command line: ``--source PATH --dest PATH [--force-fp16 BOOL]``."""
    import click

    @click.command()
    @click.option("--source", required=True, metavar="PATH",
                  help="Input reference pickle (TF-era or modern)")
    @click.option("--dest", required=True, metavar="PATH",
                  help="Output checkpoint")
    @click.option("--force-fp16", type=bool, default=False,
                  show_default=True,
                  help="Force mixed precision (bf16 blocks)")
    def cli(source, dest, force_fp16):
        click.echo(f'Loading "{source}"...')
        kinds = convert_pickle(source, dest, force_fp16=force_fp16)
        for name, kind in kinds.items():
            click.echo(f"  {name}: {kind}")
        click.echo(f'Saved "{dest}".')

    cli.main(args=argv, standalone_mode=True)


if __name__ == "__main__":
    main()
