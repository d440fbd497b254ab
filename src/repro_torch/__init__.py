"""PyTorch/CUDA port of the FFT gradient-compression system.

A second package beside the JAX reference (``repro``): it mirrors that
package's layout and names so each module's counterpart is easy to find,
imports ``torch`` and never ``jax``, and runs its hot-path kernels as CUDA
C++ written for Hopper (``kernels/csrc``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise (``device.resolve``).
"""
