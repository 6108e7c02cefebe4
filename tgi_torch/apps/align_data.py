"""Face-alignment CLI: raw images -> FFHQ-aligned crops (twin of
``tgi/apps/align_data.py``; click is imported inside ``main``).

Behavioral parity target: utils/align_data.py (reference entry point).
Landmarks come from either source:

- ``--predictor model.dat`` — a dlib-format ``shape_predictor`` (e.g.
  the published shape_predictor_68_face_landmarks.dat), read and
  evaluated natively by ``tgi_torch.utils.landmarks`` (no dlib needed); the
  face box defaults to a centered crop, or OpenCV YuNet via ``--yunet``;
- ``--landmarks lm.json`` — a precomputed ``{filename: [[x, y] * 68]}``
  sidecar (.json or pickled-dict .npy).

The FFHQ quad/warp recipe (utils/alignment.py:9-114) is applied verbatim
by ``tgi_torch.utils.alignment``.

Run: python -m tgi_torch.apps.align_data --src raw/ --dst aligned/ \
         --predictor shape_predictor_68_face_landmarks.dat --size 1024
"""

from __future__ import annotations

import json
import os


def main(argv=None):
    """Command line: ``--src DIR --dst DIR`` with ``--landmarks`` or
    ``--predictor`` (and ``--yunet``, ``--size``)."""
    import click

    @click.command()
    @click.option("--src", "src_dir", required=True, help="raw image dir")
    @click.option("--dst", "dst_dir", required=True, help="output dir")
    @click.option("--landmarks", "landmarks_path", default=None,
                  help="{filename: 68x2} .json or .npy sidecar")
    @click.option("--predictor", "predictor_path", default=None,
                  help="dlib-format shape_predictor .dat (native reader)")
    @click.option("--yunet", "yunet_model", default=None,
                  help="optional YuNet .onnx for face detection")
    @click.option("--size", "output_size", default=1024)
    def cli(src_dir, dst_dir, landmarks_path, predictor_path, yunet_model,
            output_size):
        from tgi_torch.utils.alignment import align_directory
        if landmarks_path is None:
            if predictor_path is None:
                raise click.UsageError("pass --landmarks or --predictor")
            from tgi_torch.utils.landmarks import landmarks_for_directory
            table = landmarks_for_directory(src_dir, predictor_path,
                                            yunet_model)
            landmarks_path = os.path.join(dst_dir, "_landmarks.json")
            os.makedirs(dst_dir, exist_ok=True)
            with open(landmarks_path, "w") as f:
                json.dump(table, f)
            click.echo(f"detected landmarks for {len(table)} images "
                       f"-> {landmarks_path}")
        done = align_directory(src_dir, dst_dir, landmarks_path,
                               output_size=output_size)
        click.echo(f"aligned {len(done)} images -> {dst_dir}")

    cli.main(args=argv, standalone_mode=True)


if __name__ == "__main__":
    main()
