from repro_torch.models.model import (cast_floats, forward, init_params,
                                      init_states, logits_fn)

__all__ = ["cast_floats", "forward", "init_params", "init_states",
           "logits_fn"]
