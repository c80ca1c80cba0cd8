"""Password hashing — parity with
``apps/emqx_authn/src/emqx_authn_password_hashing.erl``.

Simple algorithms (plain/md5/sha/sha256/sha512 with salt position
prefix|suffix|disable) plus pbkdf2 and bcrypt. The reference runs bcrypt
on its in-repo C++ primitive (``native/src/bcrypt.cc``); the port has no
native plane yet, so every bcrypt spec raises and names the slice that
brings it (``ROADMAP.md`` §1, the native plane). Nothing falls back.
"""

from __future__ import annotations

import hashlib
import hmac
import os
from dataclasses import dataclass


def _native_bcrypt():
    raise NotImplementedError(
        "bcrypt runs on the native plane's C++ primitive, which the port "
        "does not have yet: it comes with the native-plane slice "
        "(ROADMAP.md §1, the native plane: native/src/bcrypt.cc)")


def warm(spec: "HashSpec") -> None:
    """Fail at provider construction for a bcrypt spec (the reference
    pre-builds its native library there), not inside the first client's
    CONNECT handshake."""
    if spec.name == "bcrypt":
        _native_bcrypt()

_SIMPLE = {"plain", "md5", "sha", "sha256", "sha512"}
_DIGEST = {"md5": "md5", "sha": "sha1", "sha256": "sha256",
           "sha512": "sha512"}


@dataclass(frozen=True)
class HashSpec:
    name: str = "sha256"             # plain|md5|sha|sha256|sha512|pbkdf2|bcrypt
    salt_position: str = "prefix"    # prefix|suffix|disable (simple algos)
    mac_fun: str = "sha256"          # pbkdf2 PRF
    iterations: int = 4096           # pbkdf2
    dk_length: int = 32              # pbkdf2 derived-key bytes
    salt_rounds: int = 10            # bcrypt cost


def gen_salt(spec: HashSpec) -> bytes:
    if spec.name == "bcrypt":
        _native_bcrypt()
    if spec.name == "plain" or spec.salt_position == "disable":
        return b""
    return os.urandom(16).hex().encode()


def hash_password(spec: HashSpec, salt: bytes, password: bytes) -> bytes:
    if spec.name == "plain":
        return password
    if spec.name == "pbkdf2":
        return hashlib.pbkdf2_hmac(
            spec.mac_fun, password, salt, spec.iterations, spec.dk_length
        ).hex().encode()
    if spec.name == "bcrypt":
        _native_bcrypt()
    if spec.name in _SIMPLE:
        if spec.salt_position == "prefix":
            data = salt + password
        elif spec.salt_position == "suffix":
            data = password + salt
        else:
            data = password
        return hashlib.new(_DIGEST[spec.name], data).hexdigest().encode()
    raise ValueError(f"unknown hash algorithm {spec.name!r}")


def check_password(
    spec: HashSpec, salt: bytes, stored: bytes, password: bytes
) -> bool:
    if spec.name == "bcrypt":
        _native_bcrypt()
    return hmac.compare_digest(hash_password(spec, salt, password), stored)
