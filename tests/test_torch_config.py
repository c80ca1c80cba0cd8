"""The port's config plane (``emqx_tpu_torch/config/``: the HOCON subset,
the schema, the layered ``Config`` store) against the reference's.

- The cases of ``tests/test_config.py`` over both packages (``pkg``), from
  the reference's own source with the package name pointed at the port for
  ``port`` (``BrokerApp.from_config`` is each package's own).
- The same HOCON text parses to equal trees in both packages, with the
  same scalar types (durations, byte sizes, percentages, substitutions,
  object merges, arrays): hand-written documents (the smoke's boot config
  among them) and seeded random ones; a malformed text raises the same
  error with the same message.
- ``Config.init_load`` of the same text checks to the same tree, the
  schema's defaults included (``node.name`` keeps the reference's
  ``emqx_tpu@127.0.0.1``), apart from the port's one added key
  ``router.device.trie_shards`` (D10 in ``ROADMAP.md``), and an invalid
  one fails with the same error.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from test_torch_harness import PKGS, call_reference, reference_calls, \
    reference_case_names

CONFIG = reference_calls("test_config")


def test_reference_case_counts():
    assert len(reference_case_names("test_config")) == 14
    assert len(CONFIG) == 14


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case,i", CONFIG)
def test_reference_config_case(case, i, pkg, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)         # from_config's data_dir is relative
    call_reference("test_config", pkg, case, i, tmp_path=tmp_path)


def config(pkg: str):
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    return (importlib.import_module(f"{root}.config.hocon"),
            importlib.import_module(f"{root}.config.config"))


def plain(x):
    """A parsed tree as plain data: each scalar with its type's name."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [plain(v) for v in x]
    return (type(x).__name__, x)


def parse(pkg: str, text: str):
    hocon, _ = config(pkg)
    try:
        return plain(hocon.loads(text))
    except hocon.HoconError as e:
        return ("error", type(e).__name__, str(e))
    except RecursionError:    # a substitution that reaches itself
        return ("error", "RecursionError")


DOCS = [
    # the smoke's boot config, in brief
    '''
    node { name = "emqx_tpu@127.0.0.1", data_dir = "/tmp/d" }
    router.device { enable = true, max_levels = 8, n_sub_slots = 8192,
      frontier_k = 32, match_cap = 128, return_cap = 16, batch_max = 512,
      pipeline_depth = 4, min_batch = 0 }
    listeners { t { type = tcp, bind = "127.0.0.1:0" }
                w { type = ws, bind = "127.0.0.1:0" } }
    authentication = [{ mechanism = password_based,
      backend = built_in_database, user_id_type = clientid,
      password_hash_algorithm { name = sha256, salt_position = suffix },
      bootstrap_users = [{ user_id = "n0", password = "pw0" }] }]
    authorization { no_match = deny, cache { enable = true, ttl = 1m },
      sources = [{ type = file,
        rules = "deny all publish secret/#\\nallow all all #" }] }
    flapping_detect { enable = true, max_count = 3, window_time = 10s,
      ban_time = 5m }
    rewrite = [{ action = publish, source_topic = "x/#",
      re = "^x/(.+)$", dest_topic = "y/$1" }]
    auto_subscribe.topics = [{ topic = "auto/${clientid}", qos = 1 }]
    ''',
    'a = ${b}\nb = 3\nc { d = ${a} }',
    'x = 10MB\ny = 512KB\nz = 1GB\nw = 2kb',
    'p = 50%\nq = 0.5\nr = -3\ns = 1e3\nt = "1e3"',
    'arr = [1, "two", 3s, [4, {k = v}], null, true]',
    'o { a = 1 }\no { b = 2 }\no.a = 3\no2 = ${o}',
    '# comment\n// another\nk = "quoted \\"esc\\" \\n"\nk2 = unquoted value',
    'a = {',                          # malformed
    'a = ${missing}',
    'a = [1, 2',
    '"quoted.key" = 1\nplain.key = 2',
]
SCALARS = ["1", "-7", "0.25", "30s", "100ms", "5m", "2h", "1d", "1MB",
           "64KB", "80%", "true", "false", "null", '"str ing"', "bare", '"1.5"',
           "[a, b]", "[]", "{}"]


def random_doc(rng) -> str:
    """A seeded HOCON document: nested objects by braces and by dotted
    keys, repeated objects that merge, arrays and substitutions of keys
    set earlier."""
    lines, keys = [], []

    def key():
        return ".".join(f"k{int(rng.integers(0, 5))}"
                        for _ in range(int(rng.integers(1, 3))))

    for _ in range(int(rng.integers(4, 12))):
        r = rng.random()
        k = key()
        if r < 0.15 and keys:
            ref = keys[int(rng.integers(0, len(keys)))]
            lines.append(f"{k} = ${{{ref}}}")
        elif r < 0.35:
            inner = ", ".join(
                f"{key()} = {SCALARS[int(rng.integers(0, len(SCALARS)))]}"
                for _ in range(int(rng.integers(1, 4))))
            lines.append(f"{k} {{ {inner} }}")
        elif r < 0.45:
            items = ", ".join(SCALARS[int(rng.integers(0, len(SCALARS)))]
                              for _ in range(int(rng.integers(0, 4))))
            lines.append(f"{k} = [{items}]")
        else:
            value = SCALARS[int(rng.integers(0, len(SCALARS)))]
            lines.append(f"{k} = {value}")
            keys.append(k)
    return "\n".join(lines)


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_hocon_documents_parse_to_equal_trees(i):
    got, want = parse("port", DOCS[i]), parse("ref", DOCS[i])
    assert got == want
    if i == 0:
        assert got["router"]["device"]["n_sub_slots"] == ("int", 8192)


@pytest.mark.parametrize("seed", range(6))
def test_random_hocon_documents_parse_to_equal_trees(seed):
    rng = np.random.default_rng(seed)
    parsed = 0
    for _ in range(40):
        text = random_doc(rng)
        got, want = parse("port", text), parse("ref", text)
        assert got == want, text
        parsed += isinstance(got, dict)
    assert parsed >= 10


@pytest.mark.parametrize("i", [0, 1, 2])
def test_checked_config_trees_equal(i):
    """``Config.init_load`` checks the text against the schema: the same
    tree in both packages, defaults included, or the same error.  D10: the
    port's tree has ``router.device.trie_shards``, 0 by default, and
    without that one key equals the reference's."""
    text = [DOCS[0], "", 'mqtt.max_packet_size = "oops"'][i]
    out = {}
    for pkg in PKGS:
        _, cfg = config(pkg)
        c = cfg.Config()
        try:
            c.init_load(text)
            out[pkg] = plain(c.get())
        except (cfg.ConfigError, ValueError) as e:
            out[pkg] = ("error", type(e).__name__, str(e))
    if i < 2:
        assert "trie_shards" not in out["ref"]["router"]["device"]
        assert out["port"]["router"]["device"].pop("trie_shards") == \
            ("int", 0)
    assert out["port"] == out["ref"]
    if i < 2:
        assert out["port"]["node"]["name"] == ("str", "emqx_tpu@127.0.0.1")
    else:
        assert out["port"][0] == "error"
