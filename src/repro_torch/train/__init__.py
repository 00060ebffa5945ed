"""Training: the single-device trainer with checkpoint/restart, retries
and a straggler watchdog (``trainer``), and data-parallel steps over the
RPC fabric in PS and allreduce mode (``fabric_train``, a copy of
``repro.train.fabric_train``)."""
