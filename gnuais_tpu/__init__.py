"""gnuais-tpu: an accelerated AIS receiver framework.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of the
classic soundcard AIS receiver ``gnuais`` (see SURVEY.md).  The signal chain — 36-tap matched FIR,
DPLL clock recovery + slicing, NRZI decode, HDLC deframing with
bit-destuffing and CRC-16 — runs as batched array programs over
``[streams, time]`` blocks on the GPU, sharded across devices/hosts with
overlap-save halos, with host-side AIS field extraction, NMEA 0183
encoding and the full sink surface (stdout / socket / serial / DB /
JSON-AIS cache export).
"""

__version__ = "0.1.0"

from gnuais_tpu import constants  # noqa: F401
