"""The training step (port of ``rmcl_tpu/train``: ``schedule`` and ``step``)."""
