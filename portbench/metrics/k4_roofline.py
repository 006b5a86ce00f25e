"""k4_roofline (device trace): kernel K4's least time over every decode
step in the traced slice (``yardstick.k4_bound_ms`` at each step's batch
and live rows, once per layer), over K4's device time (split and
combine kernels) in the slice, in %."""
from portbench.yardstick import K4_KERNELS, k4_bound_ms


def read(run):
    s, cfg = run.summary, run.cfg
    if not s:
        return None
    size = 2 if cfg.activation_dtype == "bfloat16" else 4
    bound_ms = sum(layers * k4_bound_ms(B, cfg.num_heads, cfg.num_kv_heads,
                                        cfg.head_dim, kv_len, size)[0]
                   for kind, B, kv_len, layers in s["shapes"]
                   if kind == "k4")
    dev = sum(t for name, t in s["by_kernel"].items()
              if any(k in name for k in K4_KERNELS))
    if bound_ms <= 0 or dev <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / dev
