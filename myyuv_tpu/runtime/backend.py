"""The one backend selector: which kind of device the compute path runs on.

Every choice between device and CPU code in the package goes through
``platform()``: the codec kernels (kernels/codec.py) pick their
implementation from it, and nothing else branches on the JAX backend.
"""

from __future__ import annotations

PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """``"gpu"`` or ``"cpu"``: the platform of JAX's default backend.

    Any other backend raises — the package has no code path for it, and
    running a CPU path on an unknown accelerator would hide the device."""
    import jax

    name = jax.default_backend()
    if name in ("gpu", "cuda"):
        return "gpu"
    if name == "cpu":
        return "cpu"
    raise RuntimeError(f"unsupported JAX backend {name!r}: "
                       f"myyuv runs on {' or '.join(PLATFORMS)}")
