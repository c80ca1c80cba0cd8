"""Native (C++) runtime components and their ctypes bindings.

The shared library is built on first use with the system toolchain from
the sources in ``src/`` (a byte-for-byte copy of the JAX package's) into
``emqx_tpu_torch/_build/native/``, never next to the sources, and only
that build is loaded; ``available()`` gates every caller so the
pure-Python paths remain fully functional without a compiler.

Components (see ``src/``):

- ``frame.h``   — incremental MQTT frame splitter (emqx_frame.erl:163-217
  analogue, byte-level only);
- ``host.cc``   — epoll connection host: accept/read/frame/write in C++,
  complete frames exchanged with Python as compact event records (the
  SURVEY.md §2.4 "[NATIVE] BEAM schedulers/ports" replacement).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator, Optional

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")

# EMQX_NATIVE_SANITIZE=address|thread builds/loads a sanitized variant
# (separate artifact; the sanitizer runtime must be LD_PRELOADed into the
# interpreter — see tests/test_native_sanitizers.py for the harness)
_SANITIZE = os.environ.get("EMQX_NATIVE_SANITIZE", "")
# EMQX_NATIVE_NOFAULT=1 builds the faultline-compiled-OUT variant
# (-DEMQX_NO_FAULTLINE): bench.py's fault_overhead section compares it
# against the normal binary to prove disarmed fault sites are free
_NOFAULT = os.environ.get("EMQX_NATIVE_NOFAULT", "") == "1"
_LIB_NAME = (f"libemqx_native.{_SANITIZE}.so" if _SANITIZE
             else "libemqx_native.nofault.so" if _NOFAULT
             else "libemqx_native.so")
# the build directory: the package's own, beside the CUDA kernels' builds
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, _LIB_NAME)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _needs_build() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    return any(
        os.path.getmtime(os.path.join(_SRC_DIR, f)) > lib_mtime
        for f in os.listdir(_SRC_DIR)
    )


def _build() -> None:
    """Build the library into ``_BUILD_DIR``.  Processes that start
    together (test workers) take a file lock in turn: the first builds to
    a private name and renames it into place, the others find it fresh."""
    import fcntl
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(_LIB_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _needs_build():
            return
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
            os.path.join(_SRC_DIR, "host.cc"),
            os.path.join(_SRC_DIR, "snappy.cc"),
            os.path.join(_SRC_DIR, "loadgen.cc"),
            os.path.join(_SRC_DIR, "bcrypt.cc"),
            "-o", tmp,
        ]
        if _SANITIZE:
            cmd[1:1] = [f"-fsanitize={_SANITIZE}", "-g",
                        "-fno-omit-frame-pointer"]
        elif _NOFAULT:
            cmd[1:1] = ["-DEMQX_NO_FAULTLINE"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, _LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.emqx_host_create.restype = ctypes.c_void_p
    lib.emqx_host_create.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int]
    lib.emqx_host_port.restype = ctypes.c_int
    lib.emqx_host_port.argtypes = [ctypes.c_void_p]
    lib.emqx_host_listen_ws.restype = ctypes.c_int
    lib.emqx_host_listen_ws.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_char_p,
        ctypes.c_int]
    lib.emqx_shard_group_create.restype = ctypes.c_void_p
    lib.emqx_shard_group_create.argtypes = [ctypes.c_int]
    lib.emqx_shard_group_destroy.restype = None
    lib.emqx_shard_group_destroy.argtypes = [ctypes.c_void_p]
    lib.emqx_host_join_group.restype = ctypes.c_int
    lib.emqx_host_join_group.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.emqx_host_trunk_peer_state.restype = ctypes.c_int
    lib.emqx_host_trunk_peer_state.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
    lib.emqx_host_poll.restype = ctypes.c_long
    lib.emqx_host_poll.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    lib.emqx_host_send.restype = ctypes.c_int
    lib.emqx_host_send.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t]
    lib.emqx_host_close_conn.restype = ctypes.c_int
    lib.emqx_host_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.emqx_host_enable_fast.restype = ctypes.c_int
    lib.emqx_host_enable_fast.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_char_p]
    lib.emqx_host_trunk_ident.restype = ctypes.c_int
    lib.emqx_host_trunk_ident.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.emqx_host_disable_fast.restype = ctypes.c_int
    lib.emqx_host_disable_fast.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.emqx_host_sub_add.restype = ctypes.c_int
    lib.emqx_host_sub_add.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_uint8, ctypes.c_uint8]
    lib.emqx_host_sub_del.restype = ctypes.c_int
    lib.emqx_host_sub_del.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.emqx_host_permit.restype = ctypes.c_int
    lib.emqx_host_permit.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.emqx_host_shared_add.restype = ctypes.c_int
    lib.emqx_host_shared_add.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint8, ctypes.c_uint8]
    lib.emqx_host_shared_del.restype = ctypes.c_int
    lib.emqx_host_shared_del.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p]
    lib.emqx_subtable_shared_add.restype = None
    lib.emqx_subtable_shared_add.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint8, ctypes.c_uint8]
    lib.emqx_subtable_shared_del.restype = ctypes.c_int
    lib.emqx_subtable_shared_del.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p]
    lib.emqx_subtable_shared_pick.restype = ctypes.c_long
    lib.emqx_subtable_shared_pick.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long)]
    lib.emqx_subtable_match_many.restype = ctypes.c_long
    lib.emqx_subtable_match_many.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_long)]
    lib.emqx_subtable_shared_pick_many.restype = ctypes.c_long
    lib.emqx_subtable_shared_pick_many.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_long)]
    lib.emqx_host_permits_flush.restype = ctypes.c_int
    lib.emqx_host_permits_flush.argtypes = [ctypes.c_void_p]
    lib.emqx_host_set_lane.restype = ctypes.c_int
    lib.emqx_host_set_lane.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.emqx_host_lane_deliver.restype = ctypes.c_int
    lib.emqx_host_lane_deliver.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.emqx_host_lane_backlog.restype = ctypes.c_long
    lib.emqx_host_lane_backlog.argtypes = [ctypes.c_void_p]
    lib.emqx_host_set_max_qos.restype = ctypes.c_int
    lib.emqx_host_set_max_qos.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.emqx_host_trunk_listen.restype = ctypes.c_int
    lib.emqx_host_trunk_listen.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int]
    lib.emqx_host_set_trunk_ack_timeout.restype = ctypes.c_int
    lib.emqx_host_set_trunk_ack_timeout.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64]
    lib.emqx_host_fault_arm.restype = ctypes.c_int
    lib.emqx_host_fault_arm.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_uint64, ctypes.c_uint64]
    lib.emqx_host_fault_fired.restype = ctypes.c_long
    lib.emqx_host_fault_fired.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.emqx_store_fault_arm.restype = ctypes.c_int
    lib.emqx_store_fault_arm.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_uint64, ctypes.c_uint64]
    lib.emqx_store_fault_fired.restype = ctypes.c_long
    lib.emqx_store_fault_fired.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.emqx_store_set_compact_age.restype = ctypes.c_int
    lib.emqx_store_set_compact_age.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64]
    lib.emqx_host_trunk_connect.restype = ctypes.c_int
    lib.emqx_host_trunk_connect.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint16]
    lib.emqx_host_trunk_disconnect.restype = ctypes.c_int
    lib.emqx_host_trunk_disconnect.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
    lib.emqx_host_trunk_route_add.restype = ctypes.c_int
    lib.emqx_host_trunk_route_add.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.emqx_host_trunk_route_del.restype = ctypes.c_int
    lib.emqx_host_trunk_route_del.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.emqx_host_set_trace.restype = ctypes.c_int
    lib.emqx_host_set_trace.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
    lib.emqx_host_set_telemetry.restype = ctypes.c_int
    lib.emqx_host_set_telemetry.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64]
    lib.emqx_host_set_tracing.restype = ctypes.c_int
    lib.emqx_host_set_tracing.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
    lib.emqx_host_set_trunk_wire.restype = ctypes.c_int
    lib.emqx_host_set_trunk_wire.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.emqx_host_set_inflight_cap.restype = ctypes.c_int
    lib.emqx_host_set_inflight_cap.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.emqx_store_open.restype = ctypes.c_void_p
    lib.emqx_store_open.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
    lib.emqx_store_close.restype = None
    lib.emqx_store_close.argtypes = [ctypes.c_void_p]
    lib.emqx_store_register.restype = ctypes.c_uint64
    lib.emqx_store_register.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.emqx_store_lookup.restype = ctypes.c_uint64
    lib.emqx_store_lookup.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.emqx_store_append.restype = ctypes.c_uint64
    lib.emqx_store_append.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint8,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint16,
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_char_p,
        ctypes.c_uint32, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_uint8]
    lib.emqx_store_unregister.restype = ctypes.c_int
    lib.emqx_store_unregister.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.emqx_store_put_session.restype = ctypes.c_int
    lib.emqx_store_put_session.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_uint32]
    lib.emqx_store_sessions.restype = ctypes.c_long
    lib.emqx_store_sessions.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.emqx_store_trunk_put.restype = ctypes.c_int
    lib.emqx_store_trunk_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint8, ctypes.c_char_p, ctypes.c_size_t]
    lib.emqx_store_trunk_ack.restype = ctypes.c_int
    lib.emqx_store_trunk_ack.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.emqx_store_trunk_fetch.restype = ctypes.c_long
    lib.emqx_store_trunk_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.emqx_store_trunk_pending.restype = ctypes.c_long
    lib.emqx_store_trunk_pending.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p]
    lib.emqx_store_consume.restype = ctypes.c_long
    lib.emqx_store_consume.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32]
    lib.emqx_store_fetch.restype = ctypes.c_long
    lib.emqx_store_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.emqx_store_pending.restype = ctypes.c_long
    lib.emqx_store_pending.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.emqx_store_gc.restype = ctypes.c_long
    lib.emqx_store_gc.argtypes = [ctypes.c_void_p]
    lib.emqx_store_sync.restype = ctypes.c_int
    lib.emqx_store_sync.argtypes = [ctypes.c_void_p]
    lib.emqx_store_stat.restype = ctypes.c_long
    lib.emqx_store_stat.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.emqx_host_attach_store.restype = ctypes.c_int
    lib.emqx_host_attach_store.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.emqx_host_durable_add.restype = ctypes.c_int
    lib.emqx_host_durable_add.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint8]
    lib.emqx_host_durable_del.restype = ctypes.c_int
    lib.emqx_host_durable_del.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.emqx_host_note_stage.restype = ctypes.c_int
    lib.emqx_host_note_stage.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64]
    lib.emqx_host_listen_sn.restype = ctypes.c_int
    lib.emqx_host_listen_sn.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int,
        ctypes.c_int]
    lib.emqx_host_sn_predefined.restype = ctypes.c_int
    lib.emqx_host_sn_predefined.argtypes = [
        ctypes.c_void_p, ctypes.c_uint16, ctypes.c_char_p]
    lib.emqx_host_set_retained.restype = ctypes.c_int
    lib.emqx_host_set_retained.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_uint32, ctypes.c_uint8, ctypes.c_uint64]
    lib.emqx_host_retain_del.restype = ctypes.c_int
    lib.emqx_host_retain_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.emqx_host_retain_deliver.restype = ctypes.c_int
    lib.emqx_host_retain_deliver.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_uint8]
    lib.emqx_host_set_telemetry_shift.restype = ctypes.c_int
    lib.emqx_host_set_telemetry_shift.argtypes = [
        ctypes.c_void_p, ctypes.c_int]
    lib.emqx_sn_roundtrip.restype = ctypes.c_long
    lib.emqx_sn_roundtrip.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.emqx_host_listen_coap.restype = ctypes.c_int
    lib.emqx_host_listen_coap.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int]
    lib.emqx_host_coap_send.restype = ctypes.c_int
    lib.emqx_host_coap_send.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_uint32]
    lib.emqx_host_coap_retain_state.restype = ctypes.c_int
    lib.emqx_host_coap_retain_state.argtypes = [
        ctypes.c_void_p, ctypes.c_int]
    lib.emqx_host_set_coap_ack_timeout.restype = ctypes.c_int
    lib.emqx_host_set_coap_ack_timeout.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64]
    lib.emqx_coap_roundtrip.restype = ctypes.c_long
    lib.emqx_coap_roundtrip.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.emqx_loadgen_run_coap.restype = ctypes.c_int
    lib.emqx_loadgen_run_coap.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint8,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
    lib.emqx_loadgen_run_sn.restype = ctypes.c_int
    lib.emqx_loadgen_run_sn.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint8,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.emqx_subtable_match_filter.restype = ctypes.c_long
    lib.emqx_subtable_match_filter.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_long]
    lib.emqx_host_stat.restype = ctypes.c_long
    lib.emqx_host_stat.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.emqx_host_conn_idle_ms.restype = ctypes.c_long
    lib.emqx_host_conn_idle_ms.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.emqx_subtable_create.restype = ctypes.c_void_p
    lib.emqx_subtable_create.argtypes = []
    lib.emqx_subtable_destroy.restype = None
    lib.emqx_subtable_destroy.argtypes = [ctypes.c_void_p]
    lib.emqx_subtable_add.restype = None
    lib.emqx_subtable_add.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_uint8, ctypes.c_uint8]
    lib.emqx_subtable_del.restype = ctypes.c_int
    lib.emqx_subtable_del.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.emqx_subtable_match.restype = ctypes.c_long
    lib.emqx_subtable_match.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_long]
    lib.emqx_bcrypt_hash.restype = ctypes.c_int
    lib.emqx_bcrypt_hash.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_char_p]
    lib.emqx_bcrypt_gensalt.restype = ctypes.c_int
    lib.emqx_bcrypt_gensalt.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p]
    lib.emqx_loadgen_run.restype = ctypes.c_int
    lib.emqx_loadgen_run.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint8, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64)]
    lib.emqx_host_set_keepalive.restype = ctypes.c_int
    lib.emqx_host_set_keepalive.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.emqx_host_set_park.restype = ctypes.c_int
    lib.emqx_host_set_park.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint64]
    lib.emqx_host_synth_conns.restype = ctypes.c_int
    lib.emqx_host_synth_conns.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_char_p]
    lib.emqx_host_conn_counts.restype = ctypes.c_int
    lib.emqx_host_conn_counts.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.emqx_wheel_selftest.restype = ctypes.c_long
    lib.emqx_wheel_selftest.argtypes = [
        ctypes.c_uint64, ctypes.c_uint32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.emqx_loadgen_conn_scale.restype = ctypes.c_int
    lib.emqx_loadgen_conn_scale.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint16, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.emqx_host_destroy.restype = None
    lib.emqx_host_destroy.argtypes = [ctypes.c_void_p]
    lib.emqx_framer_create.restype = ctypes.c_void_p
    lib.emqx_framer_create.argtypes = [ctypes.c_uint32]
    lib.emqx_framer_feed.restype = ctypes.c_int
    lib.emqx_framer_feed.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.emqx_framer_destroy.restype = None
    lib.emqx_framer_destroy.argtypes = [ctypes.c_void_p]
    lib.emqx_buf_free.restype = None
    lib.emqx_buf_free.argtypes = [ctypes.c_void_p]
    lib.emqx_snappy_max_compressed.restype = ctypes.c_long
    lib.emqx_snappy_max_compressed.argtypes = [ctypes.c_long]
    lib.emqx_snappy_compress.restype = ctypes.c_long
    lib.emqx_snappy_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
    lib.emqx_snappy_uncompressed_length.restype = ctypes.c_long
    lib.emqx_snappy_uncompressed_length.argtypes = [
        ctypes.c_char_p, ctypes.c_long]
    lib.emqx_snappy_decompress.restype = ctypes.c_long
    lib.emqx_snappy_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Build (if stale) and load the native library; None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        try:
            if _needs_build():
                _build()
            _lib = _bind(ctypes.CDLL(_LIB_PATH))
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = (
                e.stderr if isinstance(e, subprocess.CalledProcessError)
                else str(e))
            return None
        return _lib


def available() -> bool:
    return load() is not None


def build_error() -> Optional[str]:
    return _build_error


# ---------------------------------------------------------------------------
# thin object wrappers


class NativeFramer:
    """ctypes wrapper over the C++ incremental framer (parity-test surface)."""

    def __init__(self, max_size: int = 0x0FFFFFFF):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError(f"native lib unavailable: {_build_error}")
        self._h = self._lib.emqx_framer_create(max_size)

    def feed(self, data: bytes) -> list[bytes]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        st = self._lib.emqx_framer_feed(
            self._h, data, len(data), ctypes.byref(out), ctypes.byref(out_len))
        raw = ctypes.string_at(out, out_len.value)
        self._lib.emqx_buf_free(out)
        frames, pos = [], 0
        while pos < len(raw):
            n = int.from_bytes(raw[pos:pos + 4], "little")
            pos += 4
            frames.append(raw[pos:pos + n])
            pos += n
        if st != 0:
            raise ValueError(f"frame error status={st}")
        return frames

    def close(self) -> None:
        if self._h:
            self._lib.emqx_framer_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


# event kinds from host.cc
EV_OPEN, EV_FRAME, EV_CLOSED, EV_LANE, EV_TAP, EV_ACKS = 1, 2, 3, 4, 6, 7
EV_TELEMETRY = 8
EV_TRUNK = 9
EV_DURABLE = 10     # batched durable-store record (round 10)
EV_HANDOFF = 11     # live plane demotion: AckState -> Python session
EV_SPANS = 12       # distributed-tracing spans + ledger (round 13)
EV_COAP = 13        # CoAP exchange degraded whole to the Python oracle
                    # (round 19): payload = the raw datagram verbatim


def parse_durable(payload: bytes) -> tuple[int, int, list[tuple]]:
    """Decode one kind-10 durable record into ``(base_guid, ts_ms,
    [(origin_conn, flags, [tokens], topic, payload, trace_id, cid),
    ...])`` — entry i's guid is ``base_guid + i``; flags bits1-2 =
    qos, bit3 = publisher DUP (bit0 = payload-inline, bit4 =
    trace-id-present and bit5 = clientid-present are resolved here;
    trace_id is 0 for unsampled publishes, cid is "" when the
    publisher's clientid was unknown)."""
    base = int.from_bytes(payload[0:8], "little")
    ts = int.from_bytes(payload[8:16], "little")
    n = int.from_bytes(payload[16:20], "little")
    out: list[tuple] = []
    pos, blen = 20, len(payload)
    body = b""
    for _ in range(n):
        if pos + 11 > blen:
            break
        origin = int.from_bytes(payload[pos:pos + 8], "little")
        flags = payload[pos + 8]
        ntok = int.from_bytes(payload[pos + 9:pos + 11], "little")
        pos += 11
        if pos + 8 * ntok + 2 > blen:
            break
        toks = [int.from_bytes(payload[pos + 8 * i:pos + 8 * i + 8],
                               "little") for i in range(ntok)]
        pos += 8 * ntok
        tlen = int.from_bytes(payload[pos:pos + 2], "little")
        pos += 2
        topic = payload[pos:pos + tlen].decode("utf-8", "replace")
        pos += tlen
        trace = 0
        if flags & 0x10:
            if pos + 8 > blen:
                break
            trace = int.from_bytes(payload[pos:pos + 8], "little")
            pos += 8
        cid = ""
        if flags & 0x20:
            if pos + 1 > blen:
                break
            cl = payload[pos]
            cid = payload[pos + 1:pos + 1 + cl].decode("utf-8", "replace")
            pos += 1 + cl
        if flags & 1:
            if pos + 4 > blen:
                break
            plen = int.from_bytes(payload[pos:pos + 4], "little")
            pos += 4
            body = payload[pos:pos + plen]
            pos += plen
        out.append((origin, flags, toks, topic, body, trace, cid))
    return base, ts, out


def parse_handoff(payload: bytes) -> dict:
    """Decode one kind-11 demotion-handoff record:

    - sub 1 → ``{"awaiting": [pid...], "inflight": [(pid, qos, phase)]}``
      (phase "publish" | "pubrel")
    - sub 2 → ``{"pending": [frame bytes, ...]}``

    Chunks are additive: callers merge the fields across records."""
    out: dict = {"awaiting": [], "inflight": [], "pending": []}
    if not payload:
        return out
    sub = payload[0]
    pos = 1
    if sub == 1:
        n_aw = int.from_bytes(payload[pos:pos + 4], "little")
        pos += 4
        for _ in range(n_aw):
            out["awaiting"].append(
                int.from_bytes(payload[pos:pos + 2], "little"))
            pos += 2
        n_if = int.from_bytes(payload[pos:pos + 4], "little")
        pos += 4
        for _ in range(n_if):
            pid = int.from_bytes(payload[pos:pos + 2], "little")
            st = payload[pos + 2]
            pos += 3
            out["inflight"].append(
                (pid, 2 if st & 1 else 1,
                 "pubrel" if st & 2 else "publish"))
    elif sub == 2:
        n = int.from_bytes(payload[pos:pos + 4], "little")
        pos += 4
        for _ in range(n):
            fl = int.from_bytes(payload[pos:pos + 4], "little")
            pos += 4
            out["pending"].append(payload[pos:pos + fl])
            pos += fl
    return out

# kind-9 trunk event sub-kinds (payload[0])
TRUNK_UP, TRUNK_DOWN, TRUNK_PUNT = 1, 2, 3


def parse_trunk_punts(payload: bytes) -> list[tuple]:
    """Decode one kind-9 sub-3 record (receiver-side trunk punts) into
    ``(origin_conn, qos, dup, topic, payload)`` tuples. Payloads are
    always inline in punt records (host.cc TrunkPuntAppend); a trace id
    (flags bit4) is skipped — the message is leaving the native plane."""
    out: list[tuple] = []
    pos, n = 1, len(payload)
    while pos + 11 <= n:
        origin = int.from_bytes(payload[pos:pos + 8], "little")
        flags = payload[pos + 8]
        tlen = int.from_bytes(payload[pos + 9:pos + 11], "little")
        pos += 11
        topic = payload[pos:pos + tlen].decode("utf-8", "replace")
        pos += tlen
        if flags & 0x10:
            pos += 8          # trace_id: Python dispatch is untraced
        if pos + 4 > n:
            break
        plen = int.from_bytes(payload[pos:pos + 4], "little")
        pos += 4
        body = payload[pos:pos + plen]
        pos += plen
        out.append((origin, (flags >> 1) & 3, bool(flags & 8), topic, body))
    return out

# ---------------------------------------------------------------------------
# native telemetry plane (host.cc kind-8 records)

# histogram stage order (host.cc HistStage enum)
HIST_STAGES = ("ingress_route", "route_flush", "qos1_rtt", "qos2_rtt",
               "lane_dwell", "gil_stint", "ws_ingest",
               # trunk stages (round 9): trunk_rtt = batch flush →
               # peer ack; trunk_batch_n records ENTRIES per flushed
               # batch (occupancy — a count, not nanoseconds)
               "trunk_rtt", "trunk_batch_n",
               # durable plane (round 10): store_append = per-batch
               # store write (+policy fsync); replay_drain = resume
               # replay fetch+consume+decode (noted by Python via
               # emqx_host_note_stage on the poll thread)
               "store_append", "replay_drain",
               # edge-gateway plane (round 11): sn_ingest = sampled SN
               # datagram decode+dispatch; retain_deliver = one
               # SUBSCRIBE-triggered retained snapshot lookup+write
               "sn_ingest", "retain_deliver",
               # multi-core shards (round 12): ENTRIES per applied
               # cross-shard ring batch (occupancy — a count, the
               # trunk_batch_n convention, not nanoseconds)
               "shard_ring_n",
               # coap gateway plane (round 19): coap_ingest = sampled
               # CoAP datagram decode+dispatch; observe_notify = one
               # observe notification resolve+encode+write
               "coap_ingest", "observe_notify")

# flight-recorder event codes (host.cc FrEvent)
FR_EVENT_NAMES = {1: "open", 2: "frame", 3: "punt", 4: "fast_pub",
                  5: "deliver", 6: "drop", 7: "ack",
                  # round 13: cross-plane legs on the publisher's
                  # recorder (the FR used to go blind off-shard)
                  8: "ring_cross", 9: "trunk"}
# dump reasons (host.cc FrReason)
FR_REASON_NAMES = {1: "abnormal_close", 2: "protocol_error", 3: "trace"}

# ---------------------------------------------------------------------------
# native distributed tracing (host.cc kind-12 records, round 13)

# span stage order (host.cc SpanStage enum — the stats-lint guards the
# mapping mechanically, like HIST_STAGES)
SPAN_STAGES = ("ingress", "route", "ring_cross", "trunk_flush",
               "trunk_recv", "store_append", "replay", "deliver_write",
               "ack")

# degradation-ledger reasons. The C++ LedgerReason enum is a PREFIX of
# this tuple (ring_full/trunk_punt/shed/fault fold below the GIL);
# device_failover and store_degraded are Python-plane decisions folded
# into the same ledger by broker/native_server.py and broker/broker.py.
# "fault" (round 15) is a faultline injection firing — chaos lands in
# the SAME ledger as organic degradation (aux = the fault-site index).
# "accept_shed" (round 16) is the accept-storm rung: admission denied
# in the accept loop before any conn side effect (conn-scale plane).
# "kernel_overflow" / "kernel_hostmatch" are the device
# router's degradation legs — K/M/ret_cap spill falling back to the
# host oracle, and a whole batch served by the cpu host-matcher —
# folded by broker/broker.py at the publish_batch_collect seam.
# Python-plane, so they append at the END (the C++ enum stays a prefix).
LEDGER_REASONS = ("ring_full", "trunk_punt", "shed", "fault",
                  "accept_shed", "coap_giveup",
                  "device_failover", "store_degraded",
                  "kernel_overflow", "kernel_hostmatch")

# ---------------------------------------------------------------------------
# faultline (round 15): deterministic fault injection (fault.h)

# fault-site order (fault.h Site enum — tests/test_stats_lint.py guards
# the mechanical mapping; the nativecheck `fault` rule guards that every
# site has an annotated C++ fire site exercised by a test)
FAULT_SITES = ("conn_read", "conn_write", "conn_accept",
               "trunk_read", "trunk_write", "trunk_accept",
               "trunk_connect", "store_msync", "store_seg_open",
               "ring_seal", "ring_doorbell", "housekeep_clock")

# fault modes (fault.h Mode enum): what an armed site does when it
# fires — see the fault.h header for per-site semantics
FAULT_MODES = {"off": 0, "errno": 1, "short": 2, "blackhole": 3,
               "full": 4, "skew": 5}


def fault_site_index(site: str) -> int:
    """Site name -> fault.h enum index; unknown names FAIL loudly (the
    sanitizer-lint discipline: a typo'd site must never arm nothing)."""
    try:
        return FAULT_SITES.index(site)
    except ValueError:
        raise ValueError(
            f"unknown fault site {site!r}; valid: {FAULT_SITES}") from None


def parse_spans(payload: bytes) -> list[tuple]:
    """Decode one kind-12 payload into its sub-records:

    - ``("span", trace_id, stage_idx, t_ns, aux)`` — one point on a
      sampled publish's timeline (stage indexes SPAN_STAGES);
    - ``("ledger", reason_idx, count, trace_id, aux, t_ns)`` — one
      folded degradation-ladder entry (reason 1-indexed into
      LEDGER_REASONS).

    Sub-records never split across kind-12 chunks (host.cc SpanAppend),
    so each payload parses independently; the producing shard rides the
    event record's id slot."""
    out: list[tuple] = []
    pos, n = 0, len(payload)
    while pos < n:
        sub = payload[pos]
        pos += 1
        if sub == 1:
            if pos + 25 > n:
                break
            out.append((
                "span",
                int.from_bytes(payload[pos:pos + 8], "little"),
                payload[pos + 8],
                int.from_bytes(payload[pos + 9:pos + 17], "little"),
                int.from_bytes(payload[pos + 17:pos + 25], "little"),
            ))
            pos += 25
        elif sub == 2:
            if pos + 33 > n:
                break
            out.append((
                "ledger",
                payload[pos],
                int.from_bytes(payload[pos + 1:pos + 9], "little"),
                int.from_bytes(payload[pos + 9:pos + 17], "little"),
                int.from_bytes(payload[pos + 17:pos + 25], "little"),
                int.from_bytes(payload[pos + 25:pos + 33], "little"),
            ))
            pos += 33
        else:
            break  # unknown sub-record kind: length unknowable, stop
    return out


# Declared field widths per event-record kind — what the decoders above
# (and native_server's folds) actually consume. tests/test_native_wire_
# lint.py parses the host.cc wire-format comment and asserts the
# [uNN name] token set per kind matches this table exactly, so a field
# added or widened on ONE side fails the build (the cross-plane
# analogue of the StatSlot lint).
WIRE_FIELDS: dict[int, frozenset] = {
    6: frozenset({("u64", "publisher"), ("u8", "flags"),
                  ("u16", "tlen"), ("u32", "plen")}),
    7: frozenset({("u32", "n"), ("u64", "conn"), ("u32", "acked"),
                  ("u32", "rel"), ("u32", "inflight_now"),
                  ("u32", "pending_now")}),
    8: frozenset({("u8", "stage"), ("u64", "count_d"), ("u64", "sum_d"),
                  ("u16", "n"), ("u8", "bucket"), ("u32", "delta"),
                  ("u64", "conn"), ("u8", "reason"), ("u8", "n"),
                  ("u32", "ts_ms"), ("u8", "event"), ("u8", "ptype"),
                  ("u16", "arg"), ("u32", "topic_hash"), ("u32", "arg2"),
                  ("u32", "rtt_us"), ("u8", "qos"), ("u16", "tlen")}),
    9: frozenset({("u64", "origin"), ("u8", "flags"), ("u16", "tlen"),
                  ("u64", "trace_id"), ("u32", "plen")}),
    10: frozenset({("u64", "base_guid"), ("u64", "ts_ms"), ("u32", "n"),
                   ("u64", "origin"), ("u8", "flags"), ("u16", "ntok"),
                   ("u64", "token"), ("u16", "tlen"),
                   ("u64", "trace_id"), ("u8", "cidlen"),
                   ("u32", "plen")}),
    11: frozenset({("u32", "n_aw"), ("u16", "pid"), ("u32", "n_if"),
                   ("u8", "state"), ("u32", "n"), ("u32", "len")}),
    12: frozenset({("u64", "trace_id"), ("u8", "stage"), ("u64", "t_ns"),
                   ("u64", "aux"), ("u8", "reason"), ("u64", "count")}),
    # kind 13 carries the raw CoAP datagram verbatim — no fields
    13: frozenset(),
}


def parse_telemetry(payload: bytes) -> list[tuple]:
    """Decode one kind-8 payload into its sub-records:

    - ``("hist", stage_idx, count_delta, sum_delta_ns, {bucket: delta})``
    - ``("flight", conn_id, reason, [(ts_ms, event, ptype, arg, topic_hash,
      arg2), ...])``
    - ``("slow_ack", conn_id, rtt_us, qos, topic)``

    Sub-records never split across kind-8 chunks (host.cc TeleAppend),
    so each payload parses independently; histogram deltas from every
    chunk sum to the C++ totals exactly."""
    out: list[tuple] = []
    pos, n = 0, len(payload)
    while pos < n:
        sub = payload[pos]
        pos += 1
        if sub == 1:
            stage = payload[pos]
            cnt = int.from_bytes(payload[pos + 1:pos + 9], "little")
            sum_ns = int.from_bytes(payload[pos + 9:pos + 17], "little")
            nb = int.from_bytes(payload[pos + 17:pos + 19], "little")
            pos += 19
            buckets = {}
            for _ in range(nb):
                buckets[payload[pos]] = int.from_bytes(
                    payload[pos + 1:pos + 5], "little")
                pos += 5
            out.append(("hist", stage, cnt, sum_ns, buckets))
        elif sub == 2:
            conn = int.from_bytes(payload[pos:pos + 8], "little")
            reason = payload[pos + 8]
            cnt = payload[pos + 9]
            pos += 10
            entries = []
            for _ in range(cnt):
                entries.append((
                    int.from_bytes(payload[pos:pos + 4], "little"),
                    payload[pos + 4], payload[pos + 5],
                    int.from_bytes(payload[pos + 6:pos + 8], "little"),
                    int.from_bytes(payload[pos + 8:pos + 12], "little"),
                    int.from_bytes(payload[pos + 12:pos + 16], "little"),
                ))
                pos += 16
            out.append(("flight", conn, reason, entries))
        elif sub == 3:
            conn = int.from_bytes(payload[pos:pos + 8], "little")
            rtt_us = int.from_bytes(payload[pos + 8:pos + 12], "little")
            qos = payload[pos + 12]
            tl = int.from_bytes(payload[pos + 13:pos + 15], "little")
            pos += 15
            topic = payload[pos:pos + tl].decode("utf-8", "replace")
            pos += tl
            out.append(("slow_ack", conn, rtt_us, qos, topic))
        else:
            break  # unknown sub-record kind: length unknowable, stop
    return out


def format_flight(entries: list[tuple]) -> list[str]:
    """Human-readable flight-recorder lines (for trace logs / debug)."""
    lines = []
    base = entries[0][0] if entries else 0
    for ts_ms, event, ptype, arg, topic_hash, _arg2 in entries:
        name = FR_EVENT_NAMES.get(event, f"ev{event}")
        part = f"+{ts_ms - base}ms {name} ptype={ptype} arg={arg}"
        if topic_hash:
            part += f" topic#{topic_hash:08x}"
        lines.append(part)
    return lines

def loadgen_run(host: str, port: int, n_subs: int, n_pubs: int,
                msgs_per_pub: int, qos: int = 0, payload_len: int = 16,
                proto_ver: int = 4, idle_timeout_ms: int = 5000,
                window: int = 0, warmup: bool = True,
                ws: bool = False, salt: int = 0) -> dict:
    """Run the native load generator (loadgen.cc) against a broker.
    Blocks for the duration of the run (ctypes releases the GIL, so an
    in-process broker keeps serving). ``window=0`` blasts for peak
    throughput; ``window>0`` caps total in-flight messages so the
    latency percentiles measure the broker, not loadgen queue depth.
    ``ws=True`` runs the fleet over MQTT-over-WebSocket (point ``port``
    at a WS listener). ``salt`` offsets clientids AND the lg/<i> topic
    space so two fleets (e.g. the mixed bench's TCP + WS arms) can run
    concurrently against one broker without takeover kicks or
    cross-plane fan-out. Returns sent/received counts, wall ns and
    latency percentiles."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    out = (ctypes.c_uint64 * 8)()
    rc = lib.emqx_loadgen_run(host.encode(), port, n_subs, n_pubs,
                              msgs_per_pub, qos, payload_len, proto_ver,
                              idle_timeout_ms, window, int(warmup),
                              int(ws), int(salt), out)
    if rc != 0:
        raise RuntimeError(f"loadgen failed rc={rc}")
    keys = ("sent", "received", "wall_ns", "p50_ns", "p99_ns", "max_ns",
            "acks", "errors")
    return dict(zip(keys, out))


def loadgen_sn_run(host: str, port: int, n_subs: int, n_pubs: int,
                   msgs_per_pub: int, qos: int = 0, payload_len: int = 16,
                   idle_timeout_ms: int = 5000, window: int = 0,
                   warmup: bool = True) -> dict:
    """Run the MQTT-SN/UDP load generator (loadgen.cc, the shared sn.h
    codec) against an SN gateway port — the native host's or the
    asyncio gateway's, so the mixed bench can compare the two planes on
    identical wire traffic. Pacing is always windowed (UDP has no
    transport backpressure); ``window=0`` defaults to 1024."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    out = (ctypes.c_uint64 * 8)()
    rc = lib.emqx_loadgen_run_sn(host.encode(), port, n_subs, n_pubs,
                                 msgs_per_pub, qos, payload_len,
                                 idle_timeout_ms, window, int(warmup),
                                 out)
    if rc != 0:
        raise RuntimeError(f"sn loadgen failed rc={rc}")
    keys = ("sent", "received", "wall_ns", "p50_ns", "p99_ns", "max_ns",
            "acks", "errors")
    return dict(zip(keys, out))


def wheel_selftest(seed: int, n_ops: int = 20000) -> list[tuple]:
    """Run the C++ timer wheel's seeded self-test script (wheel.h
    SelfTestScript) and decode its op/fire journal:

    - ``("arm", key, deadline_ms)``
    - ``("cancel", key)``
    - ``("advance", now_ms, [fired keys...])``

    The connscale test replays the journal through a brute-force
    oracle: fired sets must match {armed keys whose deadline, rounded
    up to the 16ms tick, is <= the advance clock's tick} exactly."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    lib.emqx_wheel_selftest(int(seed), int(n_ops), ctypes.byref(out),
                            ctypes.byref(out_len))
    raw = ctypes.string_at(out, out_len.value)
    lib.emqx_buf_free(out)
    events: list[tuple] = []
    pos, n = 0, len(raw)
    while pos < n:
        kind = raw[pos]
        pos += 1
        if kind == 2:
            events.append(("arm",
                           int.from_bytes(raw[pos:pos + 8], "little"),
                           int.from_bytes(raw[pos + 8:pos + 16],
                                          "little")))
            pos += 16
        elif kind == 3:
            events.append(("cancel",
                           int.from_bytes(raw[pos:pos + 8], "little")))
            pos += 8
        elif kind == 1:
            now = int.from_bytes(raw[pos:pos + 8], "little")
            fired_n = int.from_bytes(raw[pos + 8:pos + 16], "little")
            pos += 16
            fired = [int.from_bytes(raw[pos + 8 * i:pos + 8 * i + 8],
                                    "little") for i in range(fired_n)]
            pos += 8 * fired_n
            events.append(("advance", now, fired))
        else:
            raise ValueError(f"bad selftest record kind {kind}")
    return events


def loadgen_conn_scale(host: str, port: int, n_conns: int,
                       burst: int = 512, keepalive_s: int = 30,
                       sub_every: int = 0, hold_ms: int = 5000,
                       proto_ver: int = 4, stop=None, live=None) -> dict:
    """Run the conn-scale herd (loadgen.cc): a connect storm of
    ``n_conns`` mostly-idle clients that then hold for ``hold_ms``
    honoring staggered keepalives; PINGREQ round trips are the
    keepalive-latency probe. ``stop``/``live`` are optional
    ctypes.c_int32 / (ctypes.c_uint64 * 4) the caller polls/sets from
    another thread (ctypes releases the GIL for the whole call)."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    out = (ctypes.c_uint64 * 8)()
    rc = lib.emqx_loadgen_conn_scale(
        host.encode(), port, int(n_conns), int(burst), int(keepalive_s),
        int(sub_every), int(hold_ms), int(proto_ver),
        ctypes.byref(stop) if stop is not None else None,
        ctypes.cast(live, ctypes.POINTER(ctypes.c_uint64))
        if live is not None else None,
        out)
    if rc != 0:
        raise RuntimeError(f"conn-scale loadgen failed rc={rc}")
    keys = ("connected", "errors", "pings", "ping_p50_ns", "ping_p99_ns",
            "ping_max_ns", "wall_ns", "broker_closes")
    return dict(zip(keys, out))


def sn_roundtrip(data: bytes) -> tuple[int, bytes]:
    """Parse + re-serialize SN datagram bytes with the NATIVE codec
    (sn.h); returns (message count, reserialized bytes). The codec
    parity test drives the Python oracle through the same vectors."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    n = lib.emqx_sn_roundtrip(data, len(data), ctypes.byref(out),
                              ctypes.byref(out_len))
    raw = ctypes.string_at(out, out_len.value)
    lib.emqx_buf_free(out)
    return int(n), raw


def coap_roundtrip(data: bytes) -> tuple[int, bytes]:
    """Parse + re-serialize one CoAP datagram with the NATIVE codec
    (coap.h); returns (message count — 0 or 1, reserialized bytes).
    The codec parity test drives the gateway/coap.py oracle through
    the same vectors."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    n = lib.emqx_coap_roundtrip(data, len(data), ctypes.byref(out),
                                ctypes.byref(out_len))
    raw = ctypes.string_at(out, out_len.value)
    lib.emqx_buf_free(out)
    return int(n), raw


def loadgen_coap_run(host: str, port: int, n_subs: int, n_pubs: int,
                     msgs_per_pub: int, qos: int = 0,
                     payload_len: int = 16, idle_timeout_ms: int = 8000,
                     window: int = 256, warmup: bool = True,
                     fanout: bool = False) -> dict:
    """CoAP observer/publisher fleet (loadgen.cc, shared coap.h codec):
    observers GET+Observe /ps topics, publishers POST to them (NON for
    qos0, CON with ?qos=1 for qos1 — acks gate the window). Runs
    IDENTICALLY against the native listener and the asyncio gateway,
    so both bench arms see the same wire traffic and pacing. With
    ``fanout`` every observer watches ONE topic (the fan-out arm)."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    out = (ctypes.c_uint64 * 8)()
    rc = lib.emqx_loadgen_run_coap(
        host.encode(), port, int(n_subs), int(n_pubs),
        int(msgs_per_pub), int(qos), int(payload_len),
        int(idle_timeout_ms), int(window), 1 if warmup else 0,
        1 if fanout else 0, out)
    if rc != 0:
        raise RuntimeError(f"coap loadgen failed rc={rc}")
    keys = ("sent", "received", "wall_ns", "p50_ns", "p99_ns", "max_ns",
            "acks", "errors")
    return dict(zip(keys, out))


class NativeSubTable:
    """Standalone wrapper over the C++ subscription table (router.h) —
    the differential-test surface against router/trie.py."""

    def __init__(self):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError(f"native lib unavailable: {_build_error}")
        self._h = self._lib.emqx_subtable_create()

    def add(self, owner: int, filter_: str, qos: int = 0,
            flags: int = 0) -> None:
        self._lib.emqx_subtable_add(self._h, owner, filter_.encode(),
                                    qos, flags)

    def remove(self, owner: int, filter_: str) -> bool:
        return bool(self._lib.emqx_subtable_del(self._h, owner,
                                                filter_.encode()))

    def match(self, topic: str) -> list[int]:
        cap = 256
        while True:
            buf = (ctypes.c_uint64 * cap)()
            n = self._lib.emqx_subtable_match(self._h, topic.encode(),
                                              buf, cap)
            if n <= cap:
                return list(buf[:n])
            cap = n

    def match_filter(self, filter_: str) -> list[int]:
        """Owners registered under EXACTLY this filter (the device
        lane's delivery lookup; differential-tested against match)."""
        cap = 256
        while True:
            buf = (ctypes.c_uint64 * cap)()
            n = self._lib.emqx_subtable_match_filter(
                self._h, filter_.encode(), buf, cap)
            if n <= cap:
                return list(buf[:n])
            cap = n

    def shared_add(self, token: int, owner: int, filter_: str,
                   qos: int = 0, flags: int = 0) -> None:
        self._lib.emqx_subtable_shared_add(self._h, token, owner,
                                           filter_.encode(), qos, flags)

    def shared_del(self, token: int, owner: int, filter_: str) -> bool:
        return bool(self._lib.emqx_subtable_shared_del(
            self._h, token, owner, filter_.encode()))

    def shared_pick(self, topic: str) -> list[tuple[int, int]]:
        """One rotating (group token, picked owner) per matched group.
        The C side is all-or-nothing: on overflow it writes nothing and
        advances no cursor (a partial pass would double-rotate on the
        retry), reporting the needed size — re-invoke bigger."""
        cap = 512
        while True:
            buf = (ctypes.c_uint64 * cap)()
            total = ctypes.c_long()
            n = self._lib.emqx_subtable_shared_pick(
                self._h, topic.encode(), buf, cap, ctypes.byref(total))
            if 2 * total.value <= cap:
                return [(buf[2 * i], buf[2 * i + 1]) for i in range(n)]
            cap = 2 * total.value + 2

    def match_many(self, topics: list[str]) -> tuple[int, int]:
        """Bulk match (bench surface): one C call for the whole topic
        batch. Returns (topics processed, total entries matched)."""
        blob = "\n".join(topics).encode()
        matches = ctypes.c_long()
        n = self._lib.emqx_subtable_match_many(
            self._h, blob, len(blob), ctypes.byref(matches))
        return n, matches.value

    def shared_pick_many(self, topics: list[str]) -> tuple[int, int]:
        """Bulk rotating picks (bench surface): one C call for the whole
        topic batch. Returns (topics processed, picks made)."""
        blob = "\n".join(topics).encode()
        picks = ctypes.c_long()
        n = self._lib.emqx_subtable_shared_pick_many(
            self._h, blob, len(blob), ctypes.byref(picks))
        return n, picks.value

    def close(self) -> None:
        if self._h:
            self._lib.emqx_subtable_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


# fast-path stat slots (host.cc StatSlot order; the drift guard in
# tests/test_stats_lint.py derives these names from the C++ enum and
# fails the build on any order/name/coverage mismatch)
STAT_NAMES = ("fast_in", "fast_out", "fast_bytes_out", "punts",
              "drops_backpressure", "drops_inflight", "native_acks",
              "shared_dispatch", "shared_no_member",
              "lane_in", "lane_out", "lane_punts", "lane_fallback",
              "lane_stale", "taps",
              "qos1_in", "qos2_in", "qos2_rel", "lane_topic_overflow",
              "ack_batches",
              "ws_handshakes", "ws_rejects", "ws_pings", "ws_closes",
              "punts_trace", "fr_dumps", "telemetry_batches",
              "trunk_out", "trunk_in", "trunk_batches_out",
              "trunk_batches_in", "trunk_punts", "trunk_replays",
              "trunk_shed",
              "durable_in", "durable_batches", "store_appends",
              "handoffs",
              "sn_in", "sn_out", "sn_qos_m1", "sn_pings",
              "sn_registers", "sn_sleep_parked", "sn_drops_oversize",
              "retain_set", "retain_del", "retain_deliver",
              "retain_msgs_out",
              "shard_ring_out", "shard_ring_in", "shard_ring_full",
              "traced_pubs", "span_batches", "faults_injected",
              # conn-scale plane (round 16): hibernation + accept shed
              "conns_parked", "conns_inflated", "conns_shed",
              "parked_pings",
              # one-recovery-path plane (round 18): the trunk qos1
              # replay ring is store-backed
              "trunk_ring_persisted", "trunk_ring_recovered",
              # coap gateway plane (round 19)
              "coap_in", "coap_notifies", "coap_pings",
              "coap_dedup_hits", "coap_rexmits", "coap_giveups",
              "coap_punts", "coap_drops_oversize")

# durable-store stat slots (store.h StoreStat order)
STORE_STAT_NAMES = ("appends", "consumed", "pending", "messages",
                    "segments", "gc_segments", "rewrites", "torn_drops",
                    "bytes", "degraded",
                    # one-recovery-path plane (round 18)
                    "replay_bytes", "sessions", "trunk_pending",
                    "meta_rewrites")

# durable-store on-disk record types (store.h kRec* constants — the
# record catalog of the ONE recovery path; tests/test_native_wire_lint
# pins name/value parity against the C++ side)
STORE_RECORD_TYPES = {"msg_batch": 1, "consume": 2, "register": 3,
                      "rewrite": 4, "session": 5, "unregister": 6,
                      "trunk": 7, "trunk_ack": 8}

# subscription-entry flags (router.h)
SUB_PUNT, SUB_NO_LOCAL, SUB_RULE_TAP, SUB_REMOTE = 1, 2, 4, 8
SUB_DURABLE = 16

# multi-core shard conn-id scheme (host.cc, round 12): bits 56-58 carry
# the shard index — above the Python punt-token space (1<<48), below
# the SN (59), durable (61), trunk (62) and trunk-sock (63) namespaces.
SHARD_SHIFT = 56
SHARD_MASK = 7
MAX_SHARDS = 8


def shard_of(conn_id: int) -> int:
    """Which shard's host owns this conn id (0 for unsharded hosts)."""
    return (conn_id >> SHARD_SHIFT) & SHARD_MASK


class NativeShardGroup:
    """The cross-shard SPSC ring group (ring.h). Python owns it: create
    BEFORE any host joins, destroy AFTER every member host is destroyed
    (the group owns the doorbell eventfds a racing producer shard may
    still write during a member's teardown)."""

    def __init__(self, n: int):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError(f"native lib unavailable: {_build_error}")
        if not 1 <= n <= MAX_SHARDS:
            raise ValueError(f"shards must be 1..{MAX_SHARDS}, got {n}")
        self.n = n
        self._h = self._lib.emqx_shard_group_create(n)
        if not self._h:
            raise OSError("cannot create shard group")

    # set True by an owner that must abandon the group (a wedged shard
    # poll thread may still push into the rings): destroy becomes a
    # no-op forever, including the gc-time __del__ path
    leaked = False

    def destroy(self) -> None:
        if self.leaked:
            return
        if self._h:
            self._lib.emqx_shard_group_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.destroy()
        except Exception:
            pass


FSYNC_POLICY = {"never": 0, "batch": 1, "interval": 2}


class NativeStore:
    """ctypes wrapper over the durable-session message store (store.h):
    a segmented mmap-backed append-only log with CRC32-framed records.
    The data plane appends through an attached ``NativeHost`` below the
    GIL; this wrapper is the Python control surface (register sessions,
    resume fetch, marker consumption, GC) and the test surface."""

    def __init__(self, dir_: str = "", segment_bytes: int = 4 << 20,
                 fsync: str = "batch"):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError(f"native lib unavailable: {_build_error}")
        policy = FSYNC_POLICY.get(fsync, 1)
        self._h = self._lib.emqx_store_open(
            dir_.encode(), segment_bytes, policy)
        if not self._h:
            raise OSError(f"cannot open durable store at {dir_!r}")
        self.dir = dir_

    def register(self, sid: str) -> int:
        """sid -> stable token (markers key on it; survives restart)."""
        return int(self._lib.emqx_store_register(self._h, sid.encode()))

    def lookup(self, sid: str) -> int:
        """sid -> token without creating one; 0 = never registered."""
        return int(self._lib.emqx_store_lookup(self._h, sid.encode()))

    def append(self, origin: int, qos: int, tokens: list[int],
               topic: str, payload: bytes, dup: bool = False,
               trace: int = 0, cid: str = "") -> int:
        """Single-message append (Python-plane persistence + test
        surface); returns the guid. ``trace`` persists a sampled trace
        id with the entry; ``cid`` persists the publisher's clientid
        (no-local / from_ attribution across restart)."""
        toks = (ctypes.c_uint64 * max(1, len(tokens)))(*tokens)
        t = topic.encode()
        c = (cid or "").encode()
        if len(c) > 255:
            # the bit5 extension carries a u8 length: an oversized
            # clientid is DROPPED (from_ degrades to "$durable", the
            # pre-round-18 behavior), never truncated — a truncated
            # prefix could falsely equal ANOTHER client's id and
            # wrongly suppress its no-local delivery. Mirrors the C++
            # kEnableFast bound.
            c = b""
        flags = (qos << 1) | (8 if dup else 0)
        return int(self._lib.emqx_store_append(
            self._h, origin, flags, toks, len(tokens),
            t, len(t), payload, len(payload), trace, c, len(c)))

    def unregister(self, sid: str) -> None:
        """Retire a sid's REGISTER token (session-expiry GC): the
        sid→token mapping, SESSION record, and leftover markers die
        with it, so a dead session stops pinning segments."""
        tok = self.lookup(sid)
        if tok:
            self._lib.emqx_store_unregister(self._h, tok)

    def put_session(self, sid: str, body: bytes) -> None:
        """Write the sid's session-catalog record (subscriptions +
        expiry metadata — the bytes the Python JSON DiskStore used to
        hold). Registers the sid when needed."""
        tok = self.register(sid)
        self._lib.emqx_store_put_session(self._h, tok, body, len(body))

    def delete_session(self, sid: str) -> None:
        tok = self.lookup(sid)
        if tok:
            self._lib.emqx_store_put_session(self._h, tok, b"", 0)

    def sessions(self) -> list[tuple[str, bytes]]:
        """All live session-catalog records as (sid, body) — the boot
        walk of the one recovery path."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        n = self._lib.emqx_store_sessions(self._h, ctypes.byref(out),
                                          ctypes.byref(out_len))
        raw = ctypes.string_at(out, out_len.value)
        self._lib.emqx_buf_free(out)
        entries, pos = [], 0
        for _ in range(n):
            sl = int.from_bytes(raw[pos + 8:pos + 10], "little")
            sid = raw[pos + 10:pos + 10 + sl].decode("utf-8", "replace")
            pos += 10 + sl
            bl = int.from_bytes(raw[pos:pos + 4], "little")
            body = raw[pos + 4:pos + 4 + bl]
            pos += 4 + bl
            entries.append((sid, body))
        return entries

    def trunk_put(self, name: str, seq: int, record: bytes,
                  has_trace: bool = False) -> None:
        """Journal one trunk replay-ring record under the peer NODE
        NAME (raw test surface; the host's data plane journals through
        its attached store)."""
        self._lib.emqx_store_trunk_put(
            self._h, name.encode(), seq, 1 if has_trace else 0,
            record, len(record))

    def trunk_ack(self, name: str, seq: int) -> None:
        self._lib.emqx_store_trunk_ack(self._h, name.encode(), seq)

    def trunk_fetch(self, name: str) -> list[tuple[int, bool, bytes]]:
        """The named peer's persisted ring in seq order:
        ``[(seq, has_trace, record bytes), ...]``."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        n = self._lib.emqx_store_trunk_fetch(
            self._h, name.encode(), ctypes.byref(out),
            ctypes.byref(out_len))
        raw = ctypes.string_at(out, out_len.value)
        self._lib.emqx_buf_free(out)
        entries, pos = [], 0
        for _ in range(n):
            seq = int.from_bytes(raw[pos:pos + 8], "little")
            tf = raw[pos + 8]
            rl = int.from_bytes(raw[pos + 9:pos + 13], "little")
            pos += 13
            entries.append((seq, bool(tf & 1), raw[pos:pos + rl]))
            pos += rl
        return entries

    def trunk_pending(self, name: str) -> int:
        return int(self._lib.emqx_store_trunk_pending(
            self._h, name.encode()))

    def consume(self, token: int, guids: list[int]) -> int:
        if not guids:
            return 0
        arr = (ctypes.c_uint64 * len(guids))(*guids)
        return int(self._lib.emqx_store_consume(
            self._h, token, arr, len(guids)))

    def fetch(self, token: int) -> list[tuple]:
        """Pending messages for ``token`` in guid (arrival) order:
        ``[(guid, origin, ts_ms, qos, dup, topic, payload, trace_id,
        cid), ...]`` — trace_id is 0 unless the appending publish was
        tagged by the native trace sampler; cid is the persisted
        origin clientid ("" = unknown)."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        n = self._lib.emqx_store_fetch(self._h, token,
                                       ctypes.byref(out),
                                       ctypes.byref(out_len))
        raw = ctypes.string_at(out, out_len.value)
        self._lib.emqx_buf_free(out)
        entries, pos = [], 0
        for _ in range(n):
            guid = int.from_bytes(raw[pos:pos + 8], "little")
            origin = int.from_bytes(raw[pos + 8:pos + 16], "little")
            ts = int.from_bytes(raw[pos + 16:pos + 24], "little")
            flags = raw[pos + 24]
            tlen = int.from_bytes(raw[pos + 25:pos + 27], "little")
            pos += 27
            topic = raw[pos:pos + tlen].decode("utf-8", "replace")
            pos += tlen
            trace = 0
            if flags & 0x10:
                trace = int.from_bytes(raw[pos:pos + 8], "little")
                pos += 8
            cid = ""
            if flags & 0x20:
                cl = raw[pos]
                cid = raw[pos + 1:pos + 1 + cl].decode("utf-8", "replace")
                pos += 1 + cl
            plen = int.from_bytes(raw[pos:pos + 4], "little")
            pos += 4
            body = raw[pos:pos + plen]
            pos += plen
            entries.append((guid, origin, ts, (flags >> 1) & 3,
                            bool(flags & 8), topic, body, trace, cid))
        return entries

    def pending(self, token: int) -> int:
        return int(self._lib.emqx_store_pending(self._h, token))

    def gc(self) -> int:
        return int(self._lib.emqx_store_gc(self._h))

    def sync(self) -> None:
        self._lib.emqx_store_sync(self._h)

    def set_compact_age_ms(self, ms: int) -> None:
        """Age-based compaction trigger (round 15): a sealed segment
        whose live tail has sat past ``ms`` re-homes regardless of the
        thin-tail byte bound — one huge live message can no longer pin
        an otherwise-dead segment forever. 0 disables; default 60s."""
        self._lib.emqx_store_set_compact_age(self._h, int(ms))

    def fault_arm(self, site: str, mode: str = "errno",
                  n_or_prob: float = 0.0, seed: int = 1,
                  key: int = 0) -> None:
        """Arm a store fault site directly (store_msync /
        store_seg_open) — the raw-store test surface; the product path
        arms through the host, which forwards here."""
        self._lib.emqx_store_fault_arm(
            self._h, fault_site_index(site), FAULT_MODES[mode],
            float(n_or_prob), int(seed), int(key))

    def fault_fired(self, site: str) -> int:
        return int(self._lib.emqx_store_fault_fired(
            self._h, fault_site_index(site)))

    def stats(self) -> dict[str, int]:
        return {name: int(self._lib.emqx_store_stat(self._h, i))
                for i, name in enumerate(STORE_STAT_NAMES)}

    def close(self) -> None:
        if self._h:
            self._lib.emqx_store_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeHost:
    """The epoll connection host. One thread calls ``poll()``; ``send`` and
    ``close_conn`` are safe from any thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_size: int = 1 << 20, max_conns: int = 1_000_000,
                 reuseport: bool = False):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError(f"native lib unavailable: {_build_error}")
        self._h = self._lib.emqx_host_create(
            host.encode(), port, max_size, max_conns, int(reuseport))
        if not self._h:
            raise OSError(f"cannot bind {host}:{port}")
        self.port = self._lib.emqx_host_port(self._h)
        self.ws_port = 0       # set by listen_ws()
        self.trunk_port = 0    # set by trunk_listen()
        self.sn_port = 0       # set by listen_sn()
        self.coap_port = 0     # set by listen_coap()
        # The poll buffer must hold at least one whole event record: 13-byte
        # header + payload up to max_size (a max-size PUBLISH frame).  A
        # smaller buffer would leave host.cc unable to ever deliver that
        # record, busy-spinning the poll thread forever. The 65600-byte
        # margin covers the largest single durable entry on top of a
        # max-size publish (host.cc kDurMaxToksPerEntry * 8 + headers) —
        # a kind-10 record larger than this buffer would be dropped
        # whole, silently skipping live persistent-session delivery.
        self._buf = ctypes.create_string_buffer(max_size + 65600)

    def poll(self, timeout_ms: int = 100) -> Iterator[tuple[int, int, bytes]]:
        """Yield ``(kind, conn_id, payload)`` events from one loop step."""
        n = self._lib.emqx_host_poll(
            self._h, self._buf, len(self._buf), timeout_ms)
        if n <= 0:
            return
        raw = self._buf.raw[:n]
        pos = 0
        while pos < n:
            kind = raw[pos]
            conn = int.from_bytes(raw[pos + 1:pos + 9], "little")
            plen = int.from_bytes(raw[pos + 9:pos + 13], "little")
            pos += 13
            yield kind, conn, raw[pos:pos + plen]
            pos += plen

    def listen_ws(self, host: str = "127.0.0.1", port: int = 0,
                  path: str = "/mqtt", reuseport: bool = False) -> int:
        """Open the RFC6455 listener (BEFORE the poll thread starts).
        Conns accepted there run the WS handshake + frame codec in C++
        in front of the MQTT framer; their OPEN events carry a
        ``ws:ip:port`` peer string. Returns the bound port."""
        p = self._lib.emqx_host_listen_ws(
            self._h, host.encode(), port, path.encode(), int(reuseport))
        if p < 0:
            raise OSError(f"cannot bind ws listener {host}:{port}")
        self.ws_port = p
        return p

    # -- multi-core shards (round 12) ---------------------------------------

    def join_group(self, group: "NativeShardGroup", shard_id: int) -> None:
        """Make this host shard ``shard_id`` of ``group`` (call BEFORE
        the poll thread starts): conn ids gain the shard prefix (bits
        56-58), cross-shard deliveries ride the group's SPSC rings, and
        the group's doorbell for this shard joins the epoll set."""
        # hold the group FIRST: ~Host writes group_->alive at destroy
        # time, so gc-order must never free the group before a member
        # host (an abandoned half-built server has no stop() to order
        # it) — held even across a failed join for symmetry
        self._group = group
        rc = self._lib.emqx_host_join_group(self._h, group._h,
                                            int(shard_id))
        if rc != 0:
            raise ValueError(f"cannot join shard group as {shard_id}")

    def trunk_peer_state(self, peer_id: int, up: bool) -> None:
        """Mirror a peer's OWNER-shard link state onto this
        (non-owner) shard: its trunk-vs-punt oracle for remote legs it
        would ring-forward to the owner (``peer_id % n_shards`` since
        round 15)."""
        self._lib.emqx_host_trunk_peer_state(self._h, peer_id,
                                             1 if up else 0)

    # -- cluster trunk (round 9) -------------------------------------------

    def trunk_listen(self, host: str = "127.0.0.1", port: int = 0,
                     reuseport: bool = False) -> int:
        """Open the cluster-trunk listener (BEFORE the poll thread
        starts). Peer hosts dial it to forward publishes below the GIL;
        received batches fan out locally without touching Python.
        ``reuseport=True`` lets every shard listen on one port (the
        round-15 link spread). Returns the bound port."""
        p = self._lib.emqx_host_trunk_listen(self._h, host.encode(), port,
                                             int(reuseport))
        if p < 0:
            raise OSError(f"cannot bind trunk listener {host}:{port}")
        self.trunk_port = p
        return p

    def set_trunk_ack_timeout(self, ms: int) -> None:
        """Silent-link watchdog deadline: a front replay-ring entry
        unacked this long on an UP link kills the link (the only
        resolution for an up-but-black partition). Default 10s;
        0 disables the watchdog."""
        self._lib.emqx_host_set_trunk_ack_timeout(self._h, int(ms))

    # -- faultline (round 15) ------------------------------------------------

    def fault_arm(self, site: str, mode: str = "errno",
                  n_or_prob: float = 0.0, seed: int = 1,
                  key: int = 0) -> None:
        """Arm one named fault site (see fault.h / FAULT_SITES).
        ``n_or_prob``: 0 fires every hit while armed; n >= 1 fires the
        next n hits then auto-disarms; 0 < p < 1 fires each hit with
        probability p from a PRNG seeded by ``seed`` (same seed + same
        hit order = the bit-identical firing sequence). ``key`` scopes
        the site to one conn/peer (0 = all). Unknown site or mode names
        raise — a typo must never arm nothing. Store sites forward to
        the attached durable store's injector."""
        idx = fault_site_index(site)
        rc = self._lib.emqx_host_fault_arm(
            self._h, idx, FAULT_MODES[mode], float(n_or_prob),
            int(seed), int(key))
        if rc != 0:
            raise ValueError(
                f"cannot arm fault site {site!r} (no store attached?)")

    def fault_disarm(self, site: str) -> None:
        idx = fault_site_index(site)
        self._lib.emqx_host_fault_arm(self._h, idx, 0, 0.0, 0, 0)

    def fault_fired(self, site: str) -> int:
        """Faults injected at ``site`` on this host so far."""
        return int(self._lib.emqx_host_fault_fired(
            self._h, fault_site_index(site)))

    def trunk_connect(self, peer_id: int, host: str, port: int) -> None:
        """Dial (or re-dial) a peer's trunk listener; the outcome
        arrives as a kind-9 UP/DOWN event. Reconnects replay the peer's
        unacked qos1 batches before new traffic."""
        self._lib.emqx_host_trunk_connect(self._h, peer_id,
                                          host.encode(), port)

    def trunk_ident(self, peer_id: int, name: str) -> None:
        """Bind ``peer_id`` to its stable NODE NAME: the durable store
        keys the persisted trunk replay ring on it (peer ids renumber
        per process). Call before trunk_connect so the previous life's
        ring merges ahead of fresh traffic."""
        self._lib.emqx_host_trunk_ident(self._h, peer_id, name.encode())

    def trunk_disconnect(self, peer_id: int, forget: bool = False) -> None:
        """Drop the peer link. ``forget=False`` keeps the replay ring
        for the next connect; ``forget=True`` erases the peer state."""
        self._lib.emqx_host_trunk_disconnect(self._h, peer_id,
                                             1 if forget else 0)

    def trunk_route_add(self, peer_id: int, filter_: str) -> None:
        """Install a REMOTE entry (the third entry kind): publishes
        matching ``filter_`` forward over ``peer_id``'s trunk for
        QoS0/1; while the trunk is down the entry behaves as a punt
        marker and the Python forward lane carries the message."""
        self._lib.emqx_host_trunk_route_add(self._h, peer_id,
                                            filter_.encode())

    def trunk_route_del(self, peer_id: int, filter_: str) -> None:
        self._lib.emqx_host_trunk_route_del(self._h, peer_id,
                                            filter_.encode())

    def send(self, conn: int, data: bytes) -> None:
        self._lib.emqx_host_send(self._h, conn, data, len(data))

    def close_conn(self, conn: int) -> None:
        self._lib.emqx_host_close_conn(self._h, conn)

    # -- fast-path control plane (thread-safe) -----------------------------

    def enable_fast(self, conn: int, proto_ver: int,
                    max_inflight: int = 0, clientid: str = "") -> None:
        """``clientid`` binds the conn's clientid for origin
        attribution: durable appends persist it (flags bit5) so
        no-local / from_ survive a restart."""
        self._lib.emqx_host_enable_fast(self._h, conn, proto_ver,
                                        max_inflight,
                                        (clientid or "").encode())

    def disable_fast(self, conn: int) -> None:
        self._lib.emqx_host_disable_fast(self._h, conn)

    def sub_add(self, owner: int, filter_: str, qos: int = 0,
                flags: int = 0) -> None:
        self._lib.emqx_host_sub_add(self._h, owner,
                                    filter_.encode(), qos, flags)

    def sub_del(self, owner: int, filter_: str) -> None:
        self._lib.emqx_host_sub_del(self._h, owner, filter_.encode())

    def permit(self, conn: int, topic: str) -> None:
        self._lib.emqx_host_permit(self._h, conn, topic.encode())

    def shared_add(self, token: int, conn: int, filter_: str,
                   qos: int = 0, flags: int = 0) -> None:
        self._lib.emqx_host_shared_add(self._h, token, conn,
                                       filter_.encode(), qos, flags)

    def shared_del(self, token: int, conn: int, filter_: str) -> None:
        self._lib.emqx_host_shared_del(self._h, token, conn,
                                       filter_.encode())

    def set_lane(self, enabled: bool) -> None:
        """Enable/disable the device match lane; disabling drains every
        parked frame to the Python slow path in arrival order."""
        self._lib.emqx_host_set_lane(self._h, 1 if enabled else 0)

    def lane_deliver(self, blob: bytes) -> None:
        """Apply one pump response blob (see host.cc LaneDeliver)."""
        self._lib.emqx_host_lane_deliver(self._h, blob, len(blob))

    def lane_backlog(self) -> int:
        return int(self._lib.emqx_host_lane_backlog(self._h))

    def set_max_qos(self, max_qos: int) -> None:
        """Mirror mqtt.max_qos_allowed: over-cap publishes skip the
        fast path so the channel can refuse them per spec."""
        self._lib.emqx_host_set_max_qos(self._h, int(max_qos))

    def set_trace(self, conn: int, on: bool) -> None:
        """Trace punt: while on, the conn's PUBLISHes bypass the fast
        path so the Python hook fold (TraceManager) sees every one, and
        its flight-recorder tail is dumped as a kind-8 record —
        immediately on attach and again at teardown."""
        self._lib.emqx_host_set_trace(self._h, conn, 1 if on else 0)

    def set_telemetry(self, enabled: bool,
                      slow_ack_ms: float = 500.0) -> None:
        """Master switch for the native telemetry plane (histograms,
        flight recorders, kind-8 export) plus the slow-ack report floor
        in milliseconds (sampled ack RTTs past it feed slow_subs)."""
        self._lib.emqx_host_set_telemetry(
            self._h, 1 if enabled else 0, int(slow_ack_ms * 1_000_000))

    def set_tracing(self, enabled: bool, shift: int = 6,
                    seed: int = 0) -> None:
        """Native distributed tracing (round 13): sample 1-in-2^shift
        natively-consumed publishes (deterministic global ticker) and
        tag them with trace ids minted under ``seed`` (the node+shard
        prefix; 0 keeps the current seed). Gates on the telemetry
        master switch too."""
        self._lib.emqx_host_set_tracing(
            self._h, 1 if enabled else 0, int(shift), int(seed))

    def set_trunk_wire(self, version: int) -> None:
        """Cap the trunk wire version this host advertises/accepts —
        tests set 0 to simulate an old peer (trace ids are then
        stripped from outgoing trunk entries, losslessly)."""
        self._lib.emqx_host_set_trunk_wire(self._h, int(version))

    # -- durable-session plane (round 10) ----------------------------------

    def attach_store(self, store: "NativeStore") -> None:
        """Attach the durable store (BEFORE the poll thread starts).
        The host borrows the handle: destroy the host first, then close
        the store."""
        self._lib.emqx_host_attach_store(self._h, store._h)

    def durable_add(self, token: int, filter_: str, qos: int = 0) -> None:
        """Install a durable entry (the fourth match-table entry kind):
        publishes matching ``filter_`` persist below the GIL for the
        session registered under ``token`` while the fast path — the
        publisher and every fast subscriber — proceeds unpunted."""
        self._lib.emqx_host_durable_add(self._h, token,
                                        filter_.encode(), qos)

    def durable_del(self, token: int, filter_: str) -> None:
        self._lib.emqx_host_durable_del(self._h, token, filter_.encode())

    def note_stage(self, stage_name: str, ns: int) -> int:
        """POLL-THREAD ONLY: record one observation into a telemetry
        stage (the resume replay_drain stamp). Returns 0, or -2 when
        called off the poll thread (refused, like conn_idle_ms)."""
        try:
            idx = HIST_STAGES.index(stage_name)
        except ValueError:
            return -1
        return int(self._lib.emqx_host_note_stage(self._h, idx, int(ns)))

    # -- mqtt-sn gateway + retained snapshot (round 11) ---------------------

    def listen_sn(self, host: str = "127.0.0.1", port: int = 0,
                  gw_id: int = 1, reuseport: bool = False) -> int:
        """Open the MQTT-SN/UDP gateway socket (BEFORE the poll thread
        starts). Datagram peers become conns on their first CONNECT;
        their OPEN events carry an ``sn:ip:port`` peer string. Returns
        the bound port."""
        p = self._lib.emqx_host_listen_sn(self._h, host.encode(), port,
                                          int(gw_id), int(reuseport))
        if p < 0:
            raise OSError(f"cannot bind sn listener {host}:{port}")
        self.sn_port = p
        return p

    def listen_coap(self, host: str = "127.0.0.1", port: int = 0,
                    reuseport: bool = False) -> int:
        """Open the CoAP/UDP gateway socket (BEFORE the poll thread
        starts). Datagram peers become conns on their first request;
        their OPEN events carry a ``coap:ip:port`` peer string.
        Returns the bound port."""
        p = self._lib.emqx_host_listen_coap(self._h, host.encode(), port,
                                            int(reuseport))
        if p < 0:
            raise OSError(f"cannot bind coap listener {host}:{port}")
        self.coap_port = p
        return p

    def coap_send(self, conn: int, data: bytes) -> None:
        """Send raw CoAP response bytes to ``conn``'s peer — the answer
        path for oracle-served (kind-13 punted) exchanges."""
        self._lib.emqx_host_coap_send(self._h, conn, data, len(data))

    def coap_retain_state(self, complete: bool) -> None:
        """Mirror whether the retained snapshot is complete (no
        props-carrying topics excluded): plain CoAP GETs serve natively
        only while it is."""
        self._lib.emqx_host_coap_retain_state(self._h,
                                              1 if complete else 0)

    def set_coap_ack_timeout(self, ms: int) -> None:
        """CON-notify retransmit base in ms (0 restores the RFC 7252
        default ACK_TIMEOUT x 1.5 = 3000ms)."""
        self._lib.emqx_host_set_coap_ack_timeout(self._h, int(ms))

    def sn_predefined(self, topic_id: int, topic: Optional[str]) -> None:
        """Install (or, with ``topic=None``, forget) a gateway-wide
        predefined topic id (MQTT-SN predefined id space)."""
        self._lib.emqx_host_sn_predefined(
            self._h, topic_id, (topic or "").encode())

    def set_retained(self, topic: str, payload: bytes, qos: int,
                     deadline_ms: int = 0) -> None:
        """Mirror one retained message into the host-side snapshot.
        ``deadline_ms`` is the EFFECTIVE absolute wall-clock expiry
        (0 = never) — the caller folds per-message and store-default
        expiry into one number."""
        self._lib.emqx_host_set_retained(
            self._h, topic.encode(), payload, len(payload), qos,
            int(deadline_ms))

    def retain_del(self, topic: str) -> None:
        self._lib.emqx_host_retain_del(self._h, topic.encode())

    def retain_deliver(self, conn: int, filter_: str,
                       max_qos: int = 0) -> None:
        """Deliver every live retained message matching ``filter_`` to
        ``conn`` below the GIL (retain=1, qos capped at ``max_qos``;
        elevated qos rides the native ack plane)."""
        self._lib.emqx_host_retain_deliver(self._h, conn,
                                           filter_.encode(), max_qos)

    def set_telemetry_shift(self, shift: int) -> None:
        """Per-message telemetry sampling override: stages sample
        1-in-2^shift (default 3 = the documented 1-in-8). Out-of-range
        values reset the default."""
        self._lib.emqx_host_set_telemetry_shift(self._h, int(shift))

    def set_inflight_cap(self, conn: int, cap: int) -> None:
        """Re-divide a conn's receive-maximum budget: set the native
        plane's inflight cap (the Python session holds the rest; the
        caller keeps the two caps summing to <= the budget)."""
        self._lib.emqx_host_set_inflight_cap(self._h, conn, int(cap))

    def permits_flush(self) -> None:
        self._lib.emqx_host_permits_flush(self._h)

    def stats(self) -> dict[str, int]:
        return {name: self._lib.emqx_host_stat(self._h, i)
                for i, name in enumerate(STAT_NAMES)}

    # -- conn-scale plane (round 16) ----------------------------------------

    def set_keepalive(self, conn: int, deadline_ms: int) -> None:
        """Arm (or, with 0, disarm) a conn's native keepalive deadline
        on the shard's timer wheel. Pass the EFFECTIVE expiry — the
        server passes 1.5x the negotiated keepalive, the MQTT grace.
        Conns armed here leave the Python housekeep scan entirely."""
        self._lib.emqx_host_set_keepalive(self._h, conn, int(deadline_ms))

    def set_park(self, enabled: bool = True, park_after_ms: int = 0,
                 accept_burst: int = 0, mem_budget_bytes: int = 0) -> None:
        """Conn-scale knobs: hibernation on/off, the no-keepalive
        park-after fallback (0 keeps the 30s default; keepalive'd conns
        park after 2x their grace), the per-cycle accept burst cap
        (defer rung) and the conn-memory shed budget (accept_shed)."""
        self._lib.emqx_host_set_park(
            self._h, 1 if enabled else 0, int(park_after_ms),
            int(accept_burst), int(mem_budget_bytes))

    def synth_conns(self, n: int, keepalive_ms: int = 0,
                    sub_every: int = 0, topic_prefix: str = "synth") -> None:
        """Bench/test surface (raw hosts only): conjure ``n`` resident
        fast conns with no socket so the conn-scale structures run at
        10^6 scale inside an fd-capped container. Not a product path —
        the server never sees these ids (no OPEN events)."""
        self._lib.emqx_host_synth_conns(
            self._h, int(n), int(keepalive_ms), int(sub_every),
            topic_prefix.encode())

    def conn_counts(self) -> dict[str, int]:
        """POLL-THREAD ONLY (the conn_idle_ms contract): resident and
        parked conn counts, parked-record bytes, armed wheel timers."""
        out = (ctypes.c_uint64 * 4)()
        rc = self._lib.emqx_host_conn_counts(self._h, out)
        if rc != 0:
            raise RuntimeError("conn_counts refused off the poll thread")
        return {"resident": int(out[0]), "parked": int(out[1]),
                "parked_bytes": int(out[2]), "timers_armed": int(out[3])}

    def conn_idle_ms(self, conn: int) -> int:
        """POLL-THREAD ONLY (unlike the other control calls): walks the
        connection table the loop mutates. Call it from the same thread
        that drives poll() — the server's housekeep does."""
        return self._lib.emqx_host_conn_idle_ms(self._h, conn)

    # set True by an owner that must abandon the host (a wedged poll
    # thread may still be inside emqx_host_poll): destroy becomes a
    # no-op forever, including the gc-time __del__ path
    leaked = False

    def destroy(self) -> None:
        if self.leaked:
            return
        if self._h:
            self._lib.emqx_host_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.destroy()
        except Exception:
            pass
