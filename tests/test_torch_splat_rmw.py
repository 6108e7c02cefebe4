"""The port's tri-plane backward against tgi's TPU route for channel
counts ``plane_splat_pack`` rejects: C = 16 runs the serialized
read-modify-write Pallas kernel ``plane_splat`` (fp32) in interpret mode.
A file of its own because that interpret loop alone takes ~40 s on one
core. Tolerance 1e-5 relative to the largest reference value, as in
``test_torch_splat.py``: the same fp32 sums in another order."""

from torch_helpers import TOL, close, tpu_route_grads


def test_grads_match_tgi_plane_splat_interpret():
    got, want = tpu_route_grads(16, 300, H=16, W=16)
    close(got[0], want[0], TOL)
    close(got[1], want[1], TOL)
