"""Streamed serving of a configuration whose weights ``weights.py`` does
not draw: ``serve_stream``'s run, as it is, with the configuration
family's own draw (``portbench/weights_<family>.py``, the port's layout
of that family) in place of ``weights``. Everything else, the window,
the load, the records and ``correct`` against ``reference/<family>.py``,
is ``serve_stream``'s: its module is loaded afresh under a name of its
own and the draw set on that copy, so the ``serve_stream`` kind's own
runs are untouched."""
from __future__ import annotations

import importlib

from portbench.harness import Outcome, load_module


def run(h) -> Outcome:
    family = h.config["family"]
    stream = load_module(h.dir / "drivers" / "serve_stream.py",
                         f"portbench_serve_stream_{family}")
    stream.weights = importlib.import_module(f"portbench.weights_{family}")
    return stream.run(h)
