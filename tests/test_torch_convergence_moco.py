"""Learning test of the port, the RMCL MoCo step of
``tests/test_convergence.py`` (EMA twins, 5-step PGD image view,
attacked-text view, 16-slot queue) on one repeated batch, at the JAX file's
configuration and criteria, the first three losses against the JAX step's
within 1e-5 relative (``tests/test_torch_convergence.py:learn``)."""

from tests.test_torch_convergence import one_thread  # noqa: F401
from tests.test_torch_convergence import learn_family


def test_moco_rmcl_overfit():
    """The query projections align with the EMA keys and repel the queue
    (JAX: moco 2.74 -> 0.83 over 60 steps at lr 2e-3; chance ln 17 = 2.83);
    the adversarial views' losses fall from their peak, reached while the
    queue fills with real keys (``chip_smoke.LEARN_FAMILIES["moco"]``)."""
    learn_family("moco", ("moco_loss", "attacked_img_loss", "attacked_txt_loss"))
