"""Training (port of ``rmcl_tpu/train``: ``schedule``, ``step``, ``loop`` with
the ``Trainer``, ``checkpoint`` and ``logging``)."""
