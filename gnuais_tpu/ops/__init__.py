"""Device kernels (JAX/XLA/Pallas) for the AIS signal chain.

Layout:
  fir.py            batched 36-tap FIR with carried history (overlap-save)
  demod.py          exact DPLL clock recovery + HDLC deframer as scans
  crc.py            batched CRC-16/X.25 for device-side frame checking
  discriminator.py  raw-IQ FM discriminator + decimation front-end
  fused.py          GPU kernel: FIR+DPLL+slotting+HDLC in one pass
"""
