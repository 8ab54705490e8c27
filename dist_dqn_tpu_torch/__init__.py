"""dist_dqn_tpu_torch: the PyTorch/CUDA port of ``dist_dqn_tpu``.

A second package beside the JAX one, with the same module paths and
names, so each module's counterpart is found at the same place. It
imports ``torch`` and ``numpy`` and nothing of ``dist_dqn_tpu``: the JAX
package is the reference the parity tests (tests/test_torch_*.py) hold
it against, never a dependency.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA and no explicit CPU request they raise
(utils/device.py ``resolve_device``).
"""
