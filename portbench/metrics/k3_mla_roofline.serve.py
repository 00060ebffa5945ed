"""K3 (flash attention forward) in MLA's prefill: the least time of the
K3 calls of the prefills inside the device trace, one a layer at the
prompt's shape, counted at the unpadded head dims
(``yardstick.mla.k3_bound``: q and k of nope + rope, v of v_head_dim;
the kernel runs v padded and both padded to its next instance), over
their device time, found by kernel name (``fa_fwd``), in %."""
from portbench.yardstick.mla import k3_bound


def read(rec):
    tr, cfg = rec.get("trace"), rec.get("config") or {}
    lens = rec.get("trace_prefill_lens", [])
    if tr is None or not lens or cfg.get("family") != "kimi_k2":
        return None
    k3 = tr.named("fa_fwd")
    if len(k3) != cfg["num_hidden_layers"] * len(lens):
        return None
    t = sum(b - a for _, a, b in k3)
    return 100.0 * cfg["num_hidden_layers"] * sum(
        k3_bound(cfg, s) for s in lens) / t
