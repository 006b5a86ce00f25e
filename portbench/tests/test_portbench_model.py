"""The decoder's model module against the harness's earlier fixed code:
the weights filler and the operation count as they were before each
configuration named its model module, copied here as the golden. At
reduced StarCoder2 and Qwen3 sizes the module's layout, through the one
filler, makes the same leaves (paths, shapes, dtypes, buffer offsets and
values), and its operation count and attention layers are the earlier
ones."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import harness, weights
from portbench.reference import decoder

SIZES = {"starcoder2-7b": dict(d_model=64, num_heads=4, num_kv_heads=2,
                               head_dim=16, d_ff=128, vocab_size=512),
         "qwen3-moe-30b-a3b": dict(d_model=64, num_heads=4, num_kv_heads=2,
                                   head_dim=16, d_ff=32, vocab_size=512,
                                   num_experts=8, experts_per_token=2)}
CASES = [(c, n) for c in SIZES for n in (2, 3, 4)]


def _cfg(config: str, layers: int):
    path = harness.HERE / "configs" / f"{config}.json"
    return harness.model_config(json.loads(path.read_text()),
                                dict(SIZES[config], num_layers=layers))


# --- the golden: portbench/weights.py and yardstick.py as they were ------


def _golden_matrix_shapes(cfg):
    d, V = cfg.d_model, cfg.vocab_size
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    out = [(("embed", "tok"), (V, d))]
    if not cfg.tie_embeddings:
        out.append((("embed", "head"), (V, d)))
    for i in range(cfg.num_layers):
        L = ("layers", str(i))
        out += [(L + ("attn", "wq"), (d, hq)), (L + ("attn", "wk"), (d, hkv)),
                (L + ("attn", "wv"), (d, hkv)), (L + ("attn", "wo"), (hq, d))]
        if cfg.family == "moe":
            E, f = cfg.num_experts, cfg.d_ff
            out += [(L + ("ffn", "router"), (d, E)),
                    (L + ("ffn", "wi"), (E, d, f)),
                    (L + ("ffn", "wo"), (E, f, d))]
            if cfg.act == "silu":
                out.append((L + ("ffn", "wg"), (E, d, f)))
        else:
            f = cfg.d_ff
            out += [(L + ("ffn", "wi"), (d, f)), (L + ("ffn", "wo"), (f, d))]
            if cfg.act == "silu":
                out.append((L + ("ffn", "wg"), (d, f)))
    return out


def _golden_make_params(cfg, seed, device):
    dtype = weights._DTYPES[cfg.param_dtype]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    shapes = _golden_matrix_shapes(cfg)
    total = sum(torch.Size(s).numel() for _, s in shapes)
    buf = torch.empty(total, dtype=dtype, device=dev)
    for a in range(0, total, weights.CHUNK):
        buf[a:a + weights.CHUNK].normal_(0.0, 0.02, generator=gen)
    params = {"embed": {}, "layers": [dict() for _ in
                                      range(cfg.num_layers)]}
    off = 0
    for path, shape in shapes:
        n = torch.Size(shape).numel()
        leaf = buf[off:off + n].view(shape)
        off += n
        if path[0] == "embed":
            params["embed"][path[1]] = leaf
        else:
            layer = params["layers"][int(path[1])]
            layer.setdefault(path[2], {})[path[3]] = leaf

    def norm():
        p = {"weight": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
        if cfg.norm_type != "rmsnorm":
            p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
        return p
    for layer in params["layers"]:
        layer["norm1"] = norm()
        layer["norm2"] = norm()
    params["final_norm"] = norm()
    return params


def _golden_layer_matmul_params(cfg):
    d, hq = cfg.d_model, cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    attn = d * hq + 2 * d * hkv + hq * d
    mats = 3 if cfg.act == "silu" else 2
    if cfg.family == "moe":
        ffn = d * cfg.num_experts + cfg.experts_per_token * mats * d * cfg.d_ff
    else:
        ffn = mats * d * cfg.d_ff
    return attn + ffn


def _golden_token_flops(cfg, position, head):
    per_layer = 2 * _golden_layer_matmul_params(cfg) + \
        4 * cfg.num_heads * cfg.head_dim * (position + 1)
    out = cfg.num_layers * per_layer
    if head:
        out += 2 * cfg.d_model * cfg.vocab_size
    return float(out)


def _golden_span_flops(cfg, start, end, head_last):
    n = end - start
    if n <= 0:
        return 0.0
    per_layer = 2 * _golden_layer_matmul_params(cfg) * n + \
        4 * cfg.num_heads * cfg.head_dim * ((end * (end + 1)
                                             - start * (start + 1)) // 2)
    out = cfg.num_layers * per_layer
    if head_last:
        out += 2 * cfg.d_model * cfg.vocab_size
    return float(out)


# --- the module against the golden ----------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


@pytest.mark.parametrize("config,layers", CASES)
def test_layout_makes_the_golden_weights(config, layers):
    cfg = _cfg(config, layers)
    got = list(_leaves(weights.make_params(cfg, 2**31 + 17, "cpu",
                                           decoder.layout)))
    want = list(_leaves(_golden_make_params(cfg, 2**31 + 17, "cpu")))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
        # the same stretch of one buffer: the matrices share one storage
        # at the same offsets, each norm is a tensor of its own
        assert a.storage_offset() == b.storage_offset(), path
        assert a.is_contiguous() == b.is_contiguous(), path
    mats = [a for p, a in got if p[-1] not in ("weight", "bias")]
    assert len({a.untyped_storage().data_ptr() for a in mats}) == 1
    assert weights.count(cfg, decoder.layout) == sum(
        a.numel() for a in mats)


@pytest.mark.parametrize("config,layers", CASES)
def test_operation_count_is_the_golden(config, layers):
    cfg = _cfg(config, layers)
    assert decoder.layer_matmul_params(cfg) == \
        _golden_layer_matmul_params(cfg)
    for pos in (0, 1, 99, 1023, 4095):
        for head in (False, True):
            assert decoder.token_flops(cfg, pos, head) == \
                _golden_token_flops(cfg, pos, head)
    for a, b in ((0, 0), (0, 1), (0, 512), (10, 20), (512, 4096),
                 (7, 3)):
        for head in (False, True):
            assert decoder.span_flops(cfg, a, b, head) == \
                _golden_span_flops(cfg, a, b, head)


@pytest.mark.parametrize("config,layers", CASES)
def test_attention_layers_are_the_stage_sizes(config, layers):
    cfg = _cfg(config, layers)
    for per_stage in range(1, layers + 1):
        for s in range(0, layers, per_stage):
            e = min(layers, s + per_stage)
            assert decoder.attention_layers(cfg, s, e) == e - s
    assert decoder.attention_layers(cfg, 0, cfg.num_layers) == layers


@pytest.mark.parametrize("config", ["starcoder2-7b", "qwen3-moe-30b-a3b",
                                    "gpt2-large"])
def test_learned_position_table_only_where_configured(config):
    from repro_torch.configs import get_config
    cfg = get_config(config).reduced(num_layers=2, max_position=96)
    params = weights.make_params(cfg, 4, "cpu", decoder.layout)
    if cfg.pos_type != "learned":
        assert "pos" not in params["embed"]
        return
    pos, tok = params["embed"]["pos"], params["embed"]["tok"]
    assert pos.shape == (cfg.max_position, cfg.d_model)
    assert pos.storage_offset() == tok.numel()      # right after ``tok``
    # the reference adds the rows of the positions it runs over
    g = torch.Generator().manual_seed(0)
    seq = torch.randint(0, cfg.vocab_size, (12,), generator=g)
    with_pos = decoder.forward_logits(cfg, params, seq, [11])
    params["embed"]["pos"] = torch.zeros_like(pos)
    assert not torch.allclose(with_pos,
                              decoder.forward_logits(cfg, params, seq, [11]))


def test_a_configuration_without_a_model_fails_at_prepare(tmp_path,
                                                          monkeypatch):
    (tmp_path / "configs").mkdir()
    config = json.loads((harness.HERE / "configs"
                         / "starcoder2-7b.json").read_text())
    del config["model"]
    (tmp_path / "configs" / "starcoder2-7b.json").write_text(
        json.dumps(config))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    with pytest.raises(ValueError, match="starcoder2-7b.json names no "
                                         "model module"):
        harness.prepare(harness.benchmark(), "sc2.code.routed", 1, 1.0,
                        False, "cpu", 0.0)
