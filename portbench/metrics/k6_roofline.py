"""k6_roofline (device trace): kernel K6's least time over every call in
the traced slice (``k6.k6_bound_ms`` at each recorded stage forward's
(B, S) and the configuration's heads, head size and state size, once per
Mamba2 layer of the forward), over K6's device time (pre-pass and scan
kernels) in the slice, in %.

The routed entry records each forward's attention layers (the model
module's ``attention_layers``); a forward's Mamba2 layers are that count
times ``ssm_layers / attention_layers`` of its stage. That is exact only
where every stage holds the same whole periods of the layer pattern, so
the metric reads nothing for any other layout, and nothing for a model
module without ``ssm_layers``."""
from portbench.k6 import K6_KERNELS, k6_bound_ms


def ssm_per_attention(run):
    """Mamba2 layers per attention layer, the same in every stage of the
    deployment; None where a stage holds no attention layer or the
    stages differ."""
    model, cfg = run.model, run.cfg
    if not hasattr(model, "ssm_layers"):
        return None
    per_stage = int(run.config["deployment"]["layers_per_stage"])
    ratios = set()
    for s in range(0, cfg.num_layers, per_stage):
        e = min(cfg.num_layers, s + per_stage)
        attn = model.attention_layers(cfg, s, e)
        if attn <= 0:
            return None
        ratios.add((model.ssm_layers(cfg, s, e), attn))
    if len({n / a for n, a in ratios}) != 1:
        return None
    n, a = ratios.pop()
    return n / a


def read(run):
    s, cfg = run.summary, run.cfg
    if not s:
        return None
    per = ssm_per_attention(run)
    if not per:
        return None
    d_in = cfg.ssm_expand * cfg.d_model
    H, P, N = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    bound_ms = sum(layers * per * k6_bound_ms(B, S, H, P, N)[0]
                   for kind, B, S, layers in s["shapes"] if kind == "k3")
    dev = sum(t for name, t in s["by_kernel"].items()
              if any(k in name for k in K6_KERNELS))
    if bound_ms <= 0 or dev <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / dev
