"""openvvc_tpu — a bit-exact VVC (H.266) decoder with a JAX device lane.

Host-side demux + CABAC entropy decoding emit per-CTU mode/residual tensors;
pixel reconstruction runs as one fused JAX/XLA program per picture on the
accelerator (an NVIDIA GPU).
See SURVEY.md for the architecture blueprint.
"""

__version__ = "0.1.0"
