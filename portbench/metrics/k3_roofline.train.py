"""K3 (flash attention forward) in training: the least time of every K3
call inside the device trace (``yardstick.bounds.attention_bound`` at
the step's (batch, seq, heads) shape, causal; the forward and its
recomputation in the backward) over their device time, in %."""
from portbench.yardstick.bounds import attention_bound


def read(rec):
    tr, cfg, mix = rec.get("trace"), rec["config"], rec.get("mix")
    if tr is None or mix is None or cfg["family"] != "moe":
        return None
    k3 = tr.named("fa_fwd")
    if not k3:
        return None
    S = mix["seq_len"]
    bound = attention_bound(mix["batch"], S, S, cfg["num_attention_heads"],
                            cfg["num_key_value_heads"], cfg["head_dim"],
                            True, cfg.get("sliding_window"))
    return 100.0 * bound * len(k3) / sum(b - a for _, a, b in k3)
