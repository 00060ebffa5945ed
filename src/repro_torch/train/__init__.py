"""Training over the RPC fabric: data-parallel steps in PS and allreduce
mode (``fabric_train``, a copy of ``repro.train.fabric_train``)."""
