"""Password hashing — parity with
``apps/emqx_authn/src/emqx_authn_password_hashing.erl``.

Simple algorithms (plain/md5/sha/sha256/sha512 with salt position
prefix|suffix|disable) plus pbkdf2 and bcrypt. bcrypt runs on the
in-repo C++ primitive (native/src/bcrypt.cc — the analogue of the
reference's bcrypt NIF, mix.exs:635), vector-tested against the
published OpenBSD/John-the-Ripper hashes; a bcrypt wheel, if present,
is preferred only as an independent cross-check surface for tests.
"""

from __future__ import annotations

import hashlib
import hmac
import os
from dataclasses import dataclass

try:  # optional wheel — used as a differential oracle when present
    import bcrypt as _bcrypt  # type: ignore
except Exception:  # pragma: no cover
    _bcrypt = None


def _native_bcrypt():
    from emqx_tpu_torch import native
    return native.load() if native.available() else None


def warm(spec: "HashSpec") -> None:
    """Pre-build the native library for bcrypt specs at provider
    construction time — the lazy path would otherwise run a multi-second
    g++ compile inside the first client's CONNECT handshake."""
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
        lib = _native_bcrypt()
        if lib is not None:
            import ctypes
            out = ctypes.create_string_buffer(32)
            rc = lib.emqx_bcrypt_gensalt(spec.salt_rounds,
                                         os.urandom(16), out)
            if rc != 0:
                raise ValueError(f"bad bcrypt cost {spec.salt_rounds}")
            return out.value
        if _bcrypt is None:
            raise RuntimeError("bcrypt not available in this build")
        return _bcrypt.gensalt(rounds=spec.salt_rounds)
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
        lib = _native_bcrypt()
        if lib is not None:
            import ctypes
            # the salt/settings prefix is the first 29 chars of a hash
            # or a gensalt() output ("$2b$NN$" + 22-char salt)
            setting = salt[:29]
            out = ctypes.create_string_buffer(64)
            rc = lib.emqx_bcrypt_hash(password, len(password),
                                      setting, out)
            if rc != 0:
                raise ValueError(f"bad bcrypt settings {setting!r}")
            return out.value
        if _bcrypt is None:
            raise RuntimeError("bcrypt not available in this build")
        return _bcrypt.hashpw(password, salt)
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
        lib = _native_bcrypt()
        if lib is not None:
            try:
                return hmac.compare_digest(
                    hash_password(spec, stored, password), stored)
            except ValueError:
                return False
        if _bcrypt is None:
            return False
        try:
            return _bcrypt.checkpw(password, stored)
        except ValueError:
            return False
    return hmac.compare_digest(hash_password(spec, salt, password), stored)
