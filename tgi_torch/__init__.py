"""tgi_torch — the PyTorch/CUDA port of ``tgi`` for NVIDIA Hopper (H100).

The JAX package ``tgi`` is the reference; this package mirrors its layout
(``ops/ nn/ render/ models/ losses/ invert/ train/ metrics/ parallel/ io/
apps/ utils/``) and its public functions,
so each module has a JAX twin that tests hold it against. Modules are
plain functions over nested dicts of tensors whose keys are the JAX
pytree's keys (which mirror the reference ``state_dict``).

The package imports torch, numpy and the standard library only: never
``jax`` and nothing of ``tgi``.

Tensors are created on an explicit ``device``; entry points default to
:func:`default_device` (``"cuda"``) and there is no CPU fallback — a
caller that wants the CPU asks for it. On a CUDA tensor each kernel
wrapper launches its hand-written kernel or raises; on a CPU tensor it
runs the kernel's plain PyTorch version.

``parallel`` maps ``tgi``'s device mesh onto PyTorch: its data axis is
the ranks of a ``torch.distributed`` group (one process per card, launched
with ``python -m torch.distributed.run``), its rays axis the devices of
one process that a render's rays are split over.
"""


def default_device() -> str:
    """The device entry points use unless the caller names another."""
    return "cuda"
