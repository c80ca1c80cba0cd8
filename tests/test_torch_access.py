"""The port's access control (``emqx_tpu_torch/access/``: authentication,
authorization, the banned table, flapping detection, PSK, hashing) against
the reference's.

- The cases of ``tests/test_access.py`` over both packages (``pkg``), from
  the reference's own source with the package name pointed at the port for
  ``port`` (a parametrised case once per parameter set); ``BrokerApp`` is
  each package's own.
- Seeded ACL files (``FileSource`` lines over ``all``, ``user=``,
  ``clientid=`` and ``ipaddr=`` subjects, ``eq`` topics and
  ``${clientid}`` / ``${username}`` placeholders) and seeded clients,
  actions and topics: both packages' ``Authz`` give the same verdict to
  every request, under ``no_match`` allow and deny.
- Every hash other than bcrypt gives the same bytes in both packages for
  the same salt and password.  bcrypt runs on each package's own native
  library (the same C++ primitive): a hash of either package checks in
  the other, the same salt gives the same hash, and a provider builds.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from test_torch_harness import PKGS, call_reference, reference_calls, \
    reference_case_names

ACCESS = reference_calls("test_access")


def test_reference_case_counts():
    assert len(reference_case_names("test_access")) == 29
    assert len(ACCESS) == 34            # test_hash_roundtrip: 6 hashes


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case,i", ACCESS)
def test_reference_access_case(case, i, pkg):
    call_reference("test_access", pkg, case, i)


def access(pkg: str, name: str):
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    return importlib.import_module(f"{root}.access.{name}")


WORDS = ["a", "b", "dev", "c1", "u1", "+", "#"]
CLIENTS = [{"clientid": "c1", "username": "u1", "peerhost": "10.0.0.7"},
           {"clientid": "c2", "username": "u2", "peerhost": "192.168.1.9"},
           {"clientid": "c3", "username": None, "peerhost": "10.1.2.3"},
           {"clientid": "dev", "username": "u1", "peerhost": "::1"}]


def acl_text(rng) -> str:
    """A seeded ACL file of 4-12 rules."""
    lines = ["# seeded"]
    for _ in range(int(rng.integers(4, 13))):
        perm = ["allow", "deny"][int(rng.integers(0, 2))]
        who = ["all", "user=u1", "clientid=c2", "ipaddr=10.0.0.0/8",
               "clientid=dev"][int(rng.integers(0, 5))]
        action = ["publish", "subscribe", "all"][int(rng.integers(0, 3))]
        topics = []
        for _ in range(int(rng.integers(1, 3))):
            levels = [WORDS[i] for i in
                      rng.integers(0, len(WORDS), int(rng.integers(1, 4)))]
            if "#" in levels:
                levels = levels[:levels.index("#") + 1]
            t = "/".join(levels)
            r = rng.random()
            if r < 0.15:
                t = "eq " + t
            elif r < 0.3:
                t = "dev/${clientid}/#"
            elif r < 0.4:
                t = "u/${username}"
            topics.append(t)
        lines.append(f"{perm} {who} {action} {','.join(topics)}")
    return "\n".join(lines)


def requests(rng, n: int) -> list:
    out = []
    for _ in range(n):
        levels = [WORDS[i] for i in rng.integers(0, 5,
                                                 int(rng.integers(1, 4)))]
        r = rng.random()
        topic = ("/".join(levels) if r < 0.6 else
                 "dev/c1/x" if r < 0.7 else "u/u1" if r < 0.8 else
                 "a/+" if r < 0.9 else "a/#")
        out.append((int(rng.integers(0, len(CLIENTS))),
                    ["publish", "subscribe"][int(rng.integers(0, 2))],
                    topic))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_seeded_acl_verdicts_equal(seed):
    rng = np.random.default_rng(seed)
    text, reqs = acl_text(rng), requests(rng, 200)
    verdicts = {}
    for pkg in PKGS:
        az = access(pkg, "authz")
        out = []
        for no_match in ("allow", "deny"):
            authz = az.Authz([az.FileSource.parse(text)], no_match=no_match)
            out.append([authz.authorize(dict(CLIENTS[c]), a, t)
                        for c, a, t in reqs])
        verdicts[pkg] = out
    assert verdicts["port"] == verdicts["ref"]
    flat = [v for vs in verdicts["port"] for v in vs]
    assert {"allow", "deny"} <= set(flat)


@pytest.mark.parametrize("name", ["plain", "md5", "sha", "sha256", "sha512",
                                  "pbkdf2"])
@pytest.mark.parametrize("position", ["prefix", "suffix", "disable"])
def test_hashes_equal_the_reference(name, position):
    rng = np.random.default_rng(7)
    for _ in range(8):
        salt = rng.bytes(int(rng.integers(0, 17))).hex().encode()
        password = rng.bytes(int(rng.integers(0, 33)))
        got = {}
        for pkg in PKGS:
            h = access(pkg, "hashing")
            spec = h.HashSpec(name=name, salt_position=position,
                              iterations=64)
            stored = h.hash_password(spec, salt, password)
            got[pkg] = (stored, h.check_password(spec, salt, stored,
                                                 password),
                        h.check_password(spec, salt, stored, password + b"!"))
        assert got["port"] == got["ref"]
        assert got["port"][1] and (name == "plain" and position == "disable"
                                   or not got["port"][2])


def test_bcrypt_waits_for_the_native_plane():
    """The native plane came: bcrypt runs on the port's own native library
    as on the reference's, at provider construction too."""
    from emqx_tpu_torch import native
    from emqx_tpu_torch.access.authn import BuiltinDbProvider
    assert native.available(), native.build_error()
    port, ref = access("port", "hashing"), access("ref", "hashing")
    spec = {p: h.HashSpec(name="bcrypt", salt_rounds=4)
            for p, h in (("port", port), ("ref", ref))}
    port.warm(spec["port"])
    BuiltinDbProvider(hash_spec=spec["port"])
    salt = port.gen_salt(spec["port"])
    assert salt.startswith(b"$2b$04$") and len(salt) == 29
    for password in (b"pw", b"", b"p\xc3\xa4ss" * 9):
        stored = port.hash_password(spec["port"], salt, password)
        assert stored == ref.hash_password(spec["ref"], salt, password)
        for h, pkg in ((port, "port"), (ref, "ref")):
            assert h.check_password(spec[pkg], b"", stored, password)
            assert not h.check_password(spec[pkg], b"", stored,
                                        password + b"!")
    port.warm(port.HashSpec(name="sha256"))             # others need nothing
