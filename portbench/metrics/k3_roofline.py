"""k3_roofline (device trace): kernel K3's least time over every call in
the traced slice (``yardstick.k3_bound_ms`` at each recorded forward's
shape, once per layer), over K3's device time in the slice, in %."""
from portbench.yardstick import K3_KERNELS, k3_bound_ms


def read(run):
    s, cfg = run.summary, run.cfg
    if not s:
        return None
    size = 2 if cfg.activation_dtype == "bfloat16" else 4
    bound_ms = sum(layers * k3_bound_ms(B, S, cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim,
                                        size)[0]
                   for kind, B, S, layers in s["shapes"] if kind == "k3")
    dev = sum(t for name, t in s["by_kernel"].items()
              if any(k in name for k in K3_KERNELS))
    if bound_ms <= 0 or dev <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / dev
