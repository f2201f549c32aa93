"""Python binding for the native HQC model (csrc/hqc_core.cpp via ctypes).

Exposes per-parameter-set classes ``Hqc128/Hqc192/Hqc256`` with the same
method surface as the reference's PyO3 classes (simulate_rs/src/hqc.rs:1-205):
``name, keypair, params, new_plaintext, secrets_from_key, num_rejections,
encaps, encaps_with_plaintext_and_r1, eprime, decode_intermediates,
decode_oracle`` — plus ``decaps``.

All methods work as both classmethods and instance methods, like the
reference's #[staticmethod] pyclasses.
"""

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_LIB = None


def _so_path():
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(root, "csrc", "libhqc_core.so")


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _so_path()
    csrc = os.path.dirname(so)
    src = os.path.join(csrc, "hqc_core.cpp")
    # The library is built on this host at first use (it is not tracked:
    # -march=native binaries do not move between hosts).  Concurrent
    # processes (test workers) serialize the build on a lock file so none
    # loads a half-written library.
    with open(os.path.join(csrc, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        stale = os.path.exists(so) and os.path.getmtime(src) > os.path.getmtime(so)
        if not os.path.exists(so) or stale:
            subprocess.run(["make", "-C", csrc], check=True)
    lib = ctypes.CDLL(so)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    lib.hqc_param.restype = ctypes.c_longlong
    lib.hqc_param.argtypes = [ctypes.c_int, ctypes.c_char_p]
    for f in ["hqc_pk_bytes", "hqc_sk_bytes", "hqc_ct_bytes", "hqc_ss_bytes", "hqc_pt_bytes"]:
        getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f).argtypes = [ctypes.c_int]
    lib.hqc_keypair.argtypes = [ctypes.c_int, u8p, u8p]
    lib.hqc_secrets_from_key.argtypes = [ctypes.c_int, u8p, u64p, u32p]
    lib.hqc_secrets_from_key.restype = ctypes.c_int
    lib.hqc_num_rejections.restype = ctypes.c_longlong
    lib.hqc_num_rejections.argtypes = [ctypes.c_int, u8p]
    lib.hqc_encaps.argtypes = [ctypes.c_int, u8p, u8p, u8p]
    lib.hqc_encaps_with_pt_r1.argtypes = [ctypes.c_int, u8p, u8p, u32p, ctypes.c_int, u8p, u8p]
    lib.hqc_eprime.argtypes = [ctypes.c_int, u8p, u8p, u8p, u8p]
    lib.hqc_decode_intermediates.argtypes = [ctypes.c_int, u8p, u8p, u8p, u8p, u8p, u8p, u64p, u64p]
    lib.hqc_decaps.argtypes = [ctypes.c_int, u8p, u8p]
    lib.hqc_decaps.restype = ctypes.c_int
    lib.hqc_decode_oracle.argtypes = [ctypes.c_int, u8p, u8p, ctypes.c_uint64, u64p, u64p]
    lib.hqc_rs_encode.argtypes = [ctypes.c_int, u8p, u8p]
    lib.hqc_rs_decode.argtypes = [ctypes.c_int, u8p]
    lib.hqc_rs_decode.restype = ctypes.c_int
    _LIB = lib
    return lib


def lib_fingerprint():
    """SHA-256 of the loaded native library — decaps timing distributions
    (and hence absolute timing-oracle thresholds) are only comparable
    between identical binaries."""
    import hashlib

    _lib()  # ensure built
    with open(_so_path(), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _buf(data):
    arr = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _out(nbytes):
    arr = np.zeros(nbytes, dtype=np.uint8)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class _HqcBase:
    VER = None
    NAME = None

    def __init__(self):
        pass

    @classmethod
    def name(cls):
        return cls.NAME

    @classmethod
    def params(cls, what):
        v = _lib().hqc_param(cls.VER, what.upper().encode())
        if v < 0:
            raise ValueError(f"No such param: {what}")
        return int(v)

    @classmethod
    def new_plaintext(cls):
        return bytearray(_lib().hqc_pt_bytes(cls.VER))

    @classmethod
    def keypair(cls):
        lib = _lib()
        pk, pkp = _out(lib.hqc_pk_bytes(cls.VER))
        sk, skp = _out(lib.hqc_sk_bytes(cls.VER))
        lib.hqc_keypair(cls.VER, pkp, skp)
        return bytes(pk.tobytes()), bytes(sk.tobytes())

    @classmethod
    def secrets_from_key(cls, secretkey):
        lib = _lib()
        n = cls.params("N")
        omega = cls.params("OMEGA")
        _skb, skp = _buf(secretkey)
        x = np.zeros((n + 63) // 64, dtype=np.uint64)
        y = np.zeros(omega, dtype=np.uint32)
        lib.hqc_secrets_from_key(
            cls.VER, skp,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return list(int(w) for w in x), list(int(p) for p in y)

    @classmethod
    def num_rejections(cls, pt):
        _b, p = _buf(pt)
        return int(_lib().hqc_num_rejections(cls.VER, p))

    @classmethod
    def encaps(cls, publickey):
        lib = _lib()
        _pkb, pkp = _buf(publickey)
        ct, ctp = _out(lib.hqc_ct_bytes(cls.VER))
        ss, ssp = _out(lib.hqc_ss_bytes(cls.VER))
        lib.hqc_encaps(cls.VER, pkp, ctp, ssp)
        return bytearray(ct.tobytes()), bytearray(ss.tobytes())

    @classmethod
    def encaps_with_plaintext_and_r1(cls, publickey, m, r1_sparse):
        lib = _lib()
        _pkb, pkp = _buf(publickey)
        _mb, mp = _buf(m)
        r1 = np.asarray(list(r1_sparse), dtype=np.uint32)
        r1p = r1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        ct, ctp = _out(lib.hqc_ct_bytes(cls.VER))
        ss, ssp = _out(lib.hqc_ss_bytes(cls.VER))
        lib.hqc_encaps_with_pt_r1(cls.VER, pkp, mp, r1p, len(r1), ctp, ssp)
        return bytearray(ct.tobytes()), bytearray(ss.tobytes())

    @classmethod
    def eprime(cls, ciphertext, secretkey, plaintext):
        lib = _lib()
        _ctb, ctp = _buf(ciphertext)
        _skb, skp = _buf(secretkey)
        _ptb, ptp = _buf(plaintext)
        nb = (cls.params("N") + 7) // 8
        out, outp = _out(nb)
        lib.hqc_eprime(cls.VER, ctp, skp, ptp, outp)
        return bytearray(out.tobytes())

    @classmethod
    def decode_intermediates(cls, ciphertext, secretkey):
        lib = _lib()
        _ctb, ctp = _buf(ciphertext)
        _skb, skp = _buf(secretkey)
        k = lib.hqc_pt_bytes(cls.VER)
        n1 = cls.params("N1")
        n1n2b = (cls.params("N1N2") + 7) // 8
        nw = (cls.params("N") + 63) // 64
        m, mp = _out(k)
        rs_enc, rsp = _out(n1)
        rm_dec, rmp = _out(n1)
        inp, inpp = _out(n1n2b)
        u = np.zeros(nw, dtype=np.uint64)
        v = np.zeros(nw, dtype=np.uint64)
        lib.hqc_decode_intermediates(
            cls.VER, ctp, skp, mp, rsp, rmp, inpp,
            u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        return (
            bytearray(m.tobytes()),
            bytearray(rs_enc.tobytes()),
            bytearray(rm_dec.tobytes()),
            bytearray(inp.tobytes()),
            [int(w) for w in u],
            [int(w) for w in v],
        )

    @classmethod
    def decaps(cls, ciphertext, secretkey):
        lib = _lib()
        _ctb, ctp = _buf(ciphertext)
        _skb, skp = _buf(secretkey)
        ss, ssp = _out(lib.hqc_ss_bytes(cls.VER))
        ok = lib.hqc_decaps(cls.VER, ctp, skp, ssp)
        return bytearray(ss.tobytes()), bool(ok)

    @classmethod
    def decode_oracle(cls, ciphertext, secretkey, num_measurements):
        lib = _lib()
        _ctb, ctp = _buf(ciphertext)
        _skb, skp = _buf(secretkey)
        out = np.zeros(int(num_measurements), dtype=np.uint64)
        n_out = np.zeros(1, dtype=np.uint64)
        lib.hqc_decode_oracle(
            cls.VER, ctp, skp, int(num_measurements),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        return [int(x) for x in out[: int(n_out[0])]]


class Hqc128(_HqcBase):
    VER = 0
    NAME = "hqc-128"


class Hqc192(_HqcBase):
    VER = 1
    NAME = "hqc-192"


class Hqc256(_HqcBase):
    VER = 2
    NAME = "hqc-256"


def hqc_by_param_set(param_set: str):
    return {"128": Hqc128, "192": Hqc192, "256": Hqc256}[str(param_set)]
