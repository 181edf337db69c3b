"""Learning test of the port, BarlowTwins of ``tests/test_convergence.py``:
the full step (frozen-key forward, PGD image view, attacked-text view, the
both view, the batch-coupled BatchNorm projector) on one repeated batch, at
the JAX file's configuration and criteria, the first three losses against
the JAX step's at BT_PARITY_RTOL (``tests/test_torch_convergence.py``, whose
note says why)."""

from tests._torch_threads import one_thread  # noqa: F401
from tests.test_torch_convergence import learn_family


def test_barlowtwins_overfit():
    """The correlation loss falls from its peak on a repeated batch (a
    negated on-diagonal term or a mis-scaled redundancy term never does),
    and so do the on-diagonal invariance terms of the text view (lr 2e-3,
    3-step PGD image view; ``chip_smoke.LEARN_FAMILIES["barlowtwins"]``)."""
    learn_family("barlowtwins")
