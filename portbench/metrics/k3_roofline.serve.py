"""K3 (flash attention forward): the least time of the K3 calls of the
prefills inside the device trace (``yardstick.bounds.attention_bound``,
one call a layer at the prompt's shape) over their device time, in %."""
from portbench.yardstick.bounds import attention_bound


def read(rec):
    tr, cfg = rec.get("trace"), rec["config"]
    lens = rec.get("trace_prefill_lens", [])
    if tr is None or not lens or cfg["family"] != "moe":
        return None
    k3 = tr.named("fa_fwd")
    if len(k3) != cfg["num_hidden_layers"] * len(lens):
        return None
    t = sum(b - a for _, a, b in k3)
    bound = cfg["num_hidden_layers"] * sum(
        attention_bound(1, s, s, cfg["num_attention_heads"],
                        cfg["num_key_value_heads"], cfg["head_dim"], True,
                        cfg.get("sliding_window")) for s in lens)
    return 100.0 * bound / t
