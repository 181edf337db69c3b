"""Learning tests of the port for the two families ``tests/test_convergence.py``
never covered: IRTR's 1-of-(1 + ``draw_false_text``) ranking cross-entropy
and ITM with its IPOT word-patch alignment.  The JAX file's tiny
configuration (``_tiny``, lr 5e-3, 60 steps) from the JAX package's initial
weights; neither family has a JAX learning run to hold its first steps to,
so the factors come from the port's measured runs, with a wide margin."""

import numpy as np

from tests._torch_threads import one_thread  # noqa: F401
from tests.test_torch_convergence import learn_family


def test_irtr_overfit():
    """Four images, each against its caption and three fixed random false
    captions: the rank CE starts at ln 4 = 1.386 and must fall below 0.05
    of it with every image ranking its caption first.  Measured: 1.3823 ->
    0.0011 over 60 steps (mean of the last five 0.0008 of the first); the
    false captions are not other pairs' captions, so this holds the CE's
    sign and scale, not a cross-pair binding."""
    history = learn_family("irtr", parity=False)
    assert abs(history[0]["irtr_loss"] - np.log(4)) < 0.05, history[0]


def test_itm_overfit():
    """Eight pairs and a false image each; the matched / unmatched split is
    drawn anew every step (``train/step.py:pretrain_draws``), so the model
    must tell each caption's image from its false one, not memorise labels.
    Measured: itm_loss 0.6929 -> 0.0004 over 60 steps (the last five 0.0006
    of the first), accuracy 1.0; the word-patch alignment's signed distance
    -0.002 -> -0.0997."""
    history = learn_family("itm", parity=False)
    assert history[-1]["itm_wpa_loss"] < history[0]["itm_wpa_loss"]
