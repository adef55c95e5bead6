"""Hand-written CUDA kernels for the port's hot spots.

Each kernel package holds:
  ops.py -- the wrapper: launches the CUDA kernel (``csrc/``) for a tensor
            on the card, the plain version for a tensor on the CPU, and
            counts its launches
  ref.py -- the plain PyTorch version, the XLA twin's arithmetic
"""
