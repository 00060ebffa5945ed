"""Entry points: step functions (``steps``), the serve CLI (``serve``)
and the TF-gRPC-Bench CLI (``bench_comm``)."""
