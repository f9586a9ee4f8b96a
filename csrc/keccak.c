/* Native Keccak-f[1600] permutation for the STROBE/Merlin transcript layer.
 *
 * CPython C-API extension (no pybind11 dependency). Exposes one function:
 *   keccak_f1600(state: bytes[200]) -> bytes[200]
 * Bit-exact with curdleproofs_jax/transcript/keccak.py (the portable
 * fallback); ~100x faster, which matters because Fiat-Shamir challenge
 * generation is the only sequential host hot path in the prover/verifier.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#define ROTL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

/* rho rotation offsets and pi lane sources for the flat i = x + 5y layout */
static const int RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                            25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

static void keccakf(uint64_t a[25]) {
  uint64_t b[25], c[5], d[5];
  for (int round = 0; round < 24; round++) {
    /* theta */
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ ROTL64(c[(x + 1) % 5], 1);
    for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
    /* rho + pi: B[y][(2x+3y)%5] = rot(A[x][y]) */
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) {
        int src = x + 5 * y;
        int dst = y + 5 * ((2 * x + 3 * y) % 5);
        int r = RHO[5 * y + x];
        b[dst] = r ? ROTL64(a[src], r) : a[src];
      }
    /* chi */
    for (int y = 0; y < 5; y++)
      for (int x = 0; x < 5; x++)
        a[x + 5 * y] =
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
    /* iota */
    a[0] ^= RC[round];
  }
}

static PyObject *py_keccak_f1600(PyObject *self, PyObject *arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  if (view.len != 200) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "state must be exactly 200 bytes");
    return NULL;
  }
  uint64_t lanes[25];
  memcpy(lanes, view.buf, 200); /* little-endian hosts only (x86/arm64) */
  PyBuffer_Release(&view);
  keccakf(lanes);
  return PyBytes_FromStringAndSize((const char *)lanes, 200);
}

/* ---- STROBE-128 + Merlin framing (native twin of transcript/strobe.py +
 * transcript/oracle.py) ---------------------------------------------------
 *
 * Fiat-Shamir transcript replay is the dominant per-proof host cost of
 * batched verification once the MSMs are merged (profiled ~25 ms/proof in
 * the Python STROBE byte plumbing). The duplex state travels as a mutable
 * 203-byte buffer owned by the Python side:
 *   [0:200] keccak state | [200] pos | [201] pos_begin | [202] cur_flags
 * One C call per logical Merlin operation (or per batch: write_many /
 * challenge_scalars), bit-exact with the Python classes (conformance
 * pinned by the Rust merlin crate vectors in tests/test_transcript.py).
 */

#define STROBE_R 166
#define FLAG_I 1
#define FLAG_A 2
#define FLAG_C 4
#define FLAG_T 8
#define FLAG_M 16
#define FLAG_K 32

typedef struct {
    uint8_t *st;   /* 200-byte keccak state */
    uint8_t *pos;  /* &buf[200] */
    uint8_t *posb; /* &buf[201] */
    uint8_t *flg;  /* &buf[202] */
} strobe;

static void strobe_run_f(strobe *s) {
    s->st[*s->pos] ^= *s->posb;
    s->st[*s->pos + 1] ^= 0x04;
    s->st[STROBE_R + 1] ^= 0x80;
    uint64_t lanes[25];
    memcpy(lanes, s->st, 200);
    keccakf(lanes);
    memcpy(s->st, lanes, 200);
    *s->pos = 0;
    *s->posb = 0;
}

static void strobe_absorb(strobe *s, const uint8_t *data, Py_ssize_t n) {
    Py_ssize_t off = 0;
    while (off < n) {
        Py_ssize_t take = STROBE_R - *s->pos;
        if (take > n - off) take = n - off;
        uint8_t *dst = s->st + *s->pos;
        for (Py_ssize_t i = 0; i < take; i++) dst[i] ^= data[off + i];
        *s->pos = (uint8_t)(*s->pos + take);
        off += take;
        if (*s->pos == STROBE_R) strobe_run_f(s);
    }
}

static void strobe_overwrite(strobe *s, const uint8_t *data, Py_ssize_t n) {
    Py_ssize_t off = 0;
    while (off < n) {
        Py_ssize_t take = STROBE_R - *s->pos;
        if (take > n - off) take = n - off;
        memcpy(s->st + *s->pos, data + off, (size_t)take);
        *s->pos = (uint8_t)(*s->pos + take);
        off += take;
        if (*s->pos == STROBE_R) strobe_run_f(s);
    }
}

static void strobe_squeeze(strobe *s, uint8_t *out, Py_ssize_t n) {
    Py_ssize_t got = 0;
    while (got < n) {
        Py_ssize_t take = STROBE_R - *s->pos;
        if (take > n - got) take = n - got;
        memcpy(out + got, s->st + *s->pos, (size_t)take);
        memset(s->st + *s->pos, 0, (size_t)take);
        *s->pos = (uint8_t)(*s->pos + take);
        got += take;
        if (*s->pos == STROBE_R) strobe_run_f(s);
    }
}

static int strobe_begin_op(strobe *s, uint8_t flags, int more) {
    if (more) {
        if (*s->flg != flags) {
            PyErr_SetString(PyExc_ValueError,
                            "STROBE op continuation with mismatched flags");
            return -1;
        }
        return 0;
    }
    if (flags & FLAG_T) {
        PyErr_SetString(PyExc_ValueError, "transport flags not supported");
        return -1;
    }
    uint8_t old_begin = *s->posb;
    *s->posb = (uint8_t)(*s->pos + 1);
    *s->flg = flags;
    uint8_t hdr[2] = {old_begin, flags};
    strobe_absorb(s, hdr, 2);
    if ((flags & (FLAG_C | FLAG_K)) && *s->pos != 0) strobe_run_f(s);
    return 0;
}

static int strobe_bind(strobe *s, Py_buffer *view) {
    if (view->len != 203 || view->readonly) {
        PyErr_SetString(PyExc_ValueError,
                        "strobe state must be a writable 203-byte buffer");
        return -1;
    }
    uint8_t *b = (uint8_t *)view->buf;
    s->st = b;
    s->pos = b + 200;
    s->posb = b + 201;
    s->flg = b + 202;
    return 0;
}

/* strobe_init(protocol_label) -> bytes[203] */
static PyObject *py_strobe_init(PyObject *self, PyObject *args) {
    Py_buffer lbl;
    if (!PyArg_ParseTuple(args, "y*", &lbl)) return NULL;
    uint8_t buf[203];
    memset(buf, 0, sizeof(buf));
    buf[0] = 1; buf[1] = STROBE_R + 2; buf[2] = 1; buf[3] = 0; buf[4] = 1;
    buf[5] = 96;
    memcpy(buf + 6, "STROBEv1.0.2", 12);
    uint64_t lanes[25];
    memcpy(lanes, buf, 200);
    keccakf(lanes);
    memcpy(buf, lanes, 200);
    strobe s = {buf, buf + 200, buf + 201, buf + 202};
    if (strobe_begin_op(&s, FLAG_M | FLAG_A, 0) < 0) {
        PyBuffer_Release(&lbl);
        return NULL;
    }
    strobe_absorb(&s, (const uint8_t *)lbl.buf, lbl.len);
    PyBuffer_Release(&lbl);
    return PyBytes_FromStringAndSize((const char *)buf, 203);
}

/* generic single op: strobe_op(state, opcode, data, more, n)
 * opcode: 0 = meta_ad, 1 = ad, 2 = key (use data); 3 = prf (use n) -> bytes
 * pass data=b"" for prf. */
static PyObject *py_strobe_op(PyObject *self, PyObject *args) {
    Py_buffer stv, data;
    int opcode, more, n = 0;
    if (!PyArg_ParseTuple(args, "w*iy*ii", &stv, &opcode, &data, &more, &n))
        return NULL;
    strobe s;
    if (strobe_bind(&s, &stv) < 0) {
        PyBuffer_Release(&stv);
        if (data.obj) PyBuffer_Release(&data);
        return NULL;
    }
    PyObject *ret = NULL;
    switch (opcode) {
    case 0:
        if (strobe_begin_op(&s, FLAG_M | FLAG_A, more) < 0) break;
        strobe_absorb(&s, (const uint8_t *)data.buf, data.len);
        ret = Py_None; Py_INCREF(ret);
        break;
    case 1:
        if (strobe_begin_op(&s, FLAG_A, more) < 0) break;
        strobe_absorb(&s, (const uint8_t *)data.buf, data.len);
        ret = Py_None; Py_INCREF(ret);
        break;
    case 2:
        if (strobe_begin_op(&s, FLAG_A | FLAG_C, more) < 0) break;
        strobe_overwrite(&s, (const uint8_t *)data.buf, data.len);
        ret = Py_None; Py_INCREF(ret);
        break;
    case 3: {
        if (strobe_begin_op(&s, FLAG_I | FLAG_A | FLAG_C, more) < 0) break;
        ret = PyBytes_FromStringAndSize(NULL, n);
        if (ret) strobe_squeeze(&s, (uint8_t *)PyBytes_AS_STRING(ret), n);
        break;
    }
    default:
        PyErr_SetString(PyExc_ValueError, "bad strobe opcode");
    }
    PyBuffer_Release(&stv);
    if (data.obj) PyBuffer_Release(&data);
    return ret;
}

/* merlin framing helpers */
static void merlin_meta_len(strobe *s, const uint8_t *label, Py_ssize_t ll,
                            uint32_t n) {
    strobe_begin_op(s, FLAG_M | FLAG_A, 0);
    strobe_absorb(s, label, ll);
    uint8_t le[4] = {(uint8_t)n, (uint8_t)(n >> 8), (uint8_t)(n >> 16),
                     (uint8_t)(n >> 24)};
    strobe_absorb(s, le, 4); /* continuation of the same meta_ad op */
    /* (matches meta_ad(label, False); meta_ad(len, True)) */
}

static void merlin_write_raw(strobe *s, const uint8_t *label, Py_ssize_t ll,
                             const uint8_t *msg, Py_ssize_t n) {
    merlin_meta_len(s, label, ll, (uint32_t)n);
    strobe_begin_op(s, FLAG_A, 0);
    strobe_absorb(s, msg, n);
}

/* merlin_write(state, label, msg) */
static PyObject *py_merlin_write(PyObject *self, PyObject *args) {
    Py_buffer stv, lbl, msg;
    if (!PyArg_ParseTuple(args, "w*y*y*", &stv, &lbl, &msg)) return NULL;
    strobe s;
    if (strobe_bind(&s, &stv) < 0) goto fail;
    merlin_write_raw(&s, (const uint8_t *)lbl.buf, lbl.len,
                     (const uint8_t *)msg.buf, msg.len);
    PyBuffer_Release(&stv); PyBuffer_Release(&lbl); PyBuffer_Release(&msg);
    Py_RETURN_NONE;
fail:
    PyBuffer_Release(&stv); PyBuffer_Release(&lbl); PyBuffer_Release(&msg);
    return NULL;
}

/* merlin_write_many(state, label, blob, item_size): frame each item_size
 * slice of blob as its own message under the same label (PointVec /
 * ScalarVec absorption in one call) */
static PyObject *py_merlin_write_many(PyObject *self, PyObject *args) {
    Py_buffer stv, lbl, blob;
    int isz;
    if (!PyArg_ParseTuple(args, "w*y*y*i", &stv, &lbl, &blob, &isz))
        return NULL;
    if (isz <= 0 || blob.len % isz) {
        PyBuffer_Release(&stv); PyBuffer_Release(&lbl); PyBuffer_Release(&blob);
        PyErr_SetString(PyExc_ValueError, "blob length % item_size");
        return NULL;
    }
    strobe s;
    if (strobe_bind(&s, &stv) < 0) {
        PyBuffer_Release(&stv); PyBuffer_Release(&lbl); PyBuffer_Release(&blob);
        return NULL;
    }
    const uint8_t *b = (const uint8_t *)blob.buf;
    for (Py_ssize_t off = 0; off < blob.len; off += isz)
        merlin_write_raw(&s, (const uint8_t *)lbl.buf, lbl.len, b + off, isz);
    PyBuffer_Release(&stv); PyBuffer_Release(&lbl); PyBuffer_Release(&blob);
    Py_RETURN_NONE;
}

/* merlin_read(state, label, n) -> n challenge bytes */
static PyObject *py_merlin_read(PyObject *self, PyObject *args) {
    Py_buffer stv, lbl;
    int n;
    if (!PyArg_ParseTuple(args, "w*y*i", &stv, &lbl, &n)) return NULL;
    strobe s;
    if (strobe_bind(&s, &stv) < 0) {
        PyBuffer_Release(&stv); PyBuffer_Release(&lbl);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, n);
    if (out) {
        merlin_meta_len(&s, (const uint8_t *)lbl.buf, lbl.len, (uint32_t)n);
        strobe_begin_op(&s, FLAG_I | FLAG_A | FLAG_C, 0);
        strobe_squeeze(&s, (uint8_t *)PyBytes_AS_STRING(out), n);
    }
    PyBuffer_Release(&stv); PyBuffer_Release(&lbl);
    return out;
}

/* r (BLS12-381 scalar field order), little-endian u64 limbs */
static const uint64_t MERLIN_R[4] = {0xffffffff00000001ULL,
                                     0x53bda402fffe5bfeULL,
                                     0x3339d80809a1d805ULL,
                                     0x73eda753299d7d48ULL};

/* merlin_challenge_scalars(state, label, count) -> count*32 bytes, each an
 * accepted (nonzero, < r) little-endian draw, re-absorbed as in
 * curdleproofs_transcript.py:17-25 */
static PyObject *py_merlin_challenge_scalars(PyObject *self, PyObject *args) {
    Py_buffer stv, lbl;
    int count;
    if (!PyArg_ParseTuple(args, "w*y*i", &stv, &lbl, &count)) return NULL;
    strobe s;
    if (strobe_bind(&s, &stv) < 0) {
        PyBuffer_Release(&stv); PyBuffer_Release(&lbl);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)count * 32);
    if (out) {
        uint8_t *o = (uint8_t *)PyBytes_AS_STRING(out);
        for (int i = 0; i < count; i++) {
            for (;;) {
                uint8_t raw[32];
                merlin_meta_len(&s, (const uint8_t *)lbl.buf, lbl.len, 32);
                strobe_begin_op(&s, FLAG_I | FLAG_A | FLAG_C, 0);
                strobe_squeeze(&s, raw, 32);
                uint64_t v[4];
                memcpy(v, raw, 32);
                int ok = 0; /* 0 < v < r */
                for (int j = 3; j >= 0; j--) {
                    if (v[j] < MERLIN_R[j]) { ok = 1; break; }
                    if (v[j] > MERLIN_R[j]) { ok = 0; break; }
                }
                int nz = (v[0] | v[1] | v[2] | v[3]) != 0;
                if (ok && nz) {
                    merlin_write_raw(&s, (const uint8_t *)lbl.buf, lbl.len,
                                     raw, 32);
                    memcpy(o + (size_t)i * 32, raw, 32);
                    break;
                }
            }
        }
    }
    PyBuffer_Release(&stv); PyBuffer_Release(&lbl);
    return out;
}

static PyMethodDef Methods[] = {
    {"keccak_f1600", py_keccak_f1600, METH_O,
     "Apply Keccak-f[1600] to a 200-byte state."},
    {"strobe_init", py_strobe_init, METH_VARARGS,
     "strobe_init(protocol_label) -> 203-byte state blob"},
    {"strobe_op", py_strobe_op, METH_VARARGS,
     "strobe_op(state, opcode, data|n, more[, n]) — 0 meta_ad, 1 ad, "
     "2 key, 3 prf"},
    {"merlin_write", py_merlin_write, METH_VARARGS,
     "merlin_write(state, label, msg)"},
    {"merlin_write_many", py_merlin_write_many, METH_VARARGS,
     "merlin_write_many(state, label, blob, item_size)"},
    {"merlin_read", py_merlin_read, METH_VARARGS,
     "merlin_read(state, label, n) -> bytes"},
    {"merlin_challenge_scalars", py_merlin_challenge_scalars, METH_VARARGS,
     "merlin_challenge_scalars(state, label, count) -> count*32 bytes"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT,
                                       "_keccak_native",
                                       "Native Keccak-f[1600] permutation.",
                                       -1,
                                       Methods,
                                       NULL,
                                       NULL,
                                       NULL,
                                       NULL};

PyMODINIT_FUNC PyInit__keccak_native(void) {
  return PyModule_Create(&moduledef);
}
