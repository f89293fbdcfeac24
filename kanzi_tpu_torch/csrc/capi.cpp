// C ABI of kanzi_tpu_torch: initCompressor/compress/disposeCompressor
// and initDecompressor/decompress/disposeDecompressor over FILE*, the
// reference API surface (src/api/Compressor.hpp:59-117,
// src/api/Decompressor.hpp:53-117) with the structs of the shared header
// native/kanzi_tpu_capi.h, so that a C program changes libraries without
// changing its source.
//
// It embeds CPython and drives the port's block container
// (kanzi_tpu_torch.io.compressed_stream) with no device argument: the
// entropy stages run on the CUDA card by default, and KANZI_TPU_DISABLE=1
// forces the host path (native C++ coders). Without a card and without
// KANZI_TPU_DISABLE the container raises, and the calls return a
// non-zero code: the library never codes on the CPU by itself. FILE* I/O
// crosses the boundary as raw pointers that libc's fread/fwrite consume
// from the embedded side.
//
// Build (kanzi_tpu_torch.utils.native.capi_library() does it):
//   g++ -O2 -shared -fPIC capi.cpp -I<native/> -I<python-include> \
//       -DKANZI_TPU_TORCH_PYROOT='"<dir holding kanzi_tpu_torch>"' \
//       -L<python-libdir> -lpython3.12 -ldl -o libkanzitpu_torch_capi.so
// The package root is the one baked in at the build, unless
// KANZI_TPU_PYROOT names another.
//
// The GIL: where this library starts the interpreter, it releases the
// GIL once the bootstrap has run, and every call takes it and gives it
// back (PyGILState_Ensure / Release), so the container's worker threads
// (jobs > 1) also run between two calls, and calls may come from any
// thread. Loaded into a running interpreter (ctypes), it uses that one.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#include "kanzi_tpu_capi.h"

#ifndef KANZI_TPU_TORCH_PYROOT
#define KANZI_TPU_TORCH_PYROOT "."
#endif

extern "C" {
struct cContext {
    PyObject* st;
    size_t blockSize;
};
struct dContext {
    PyObject* st;
};
}  // extern "C"

static const char* BOOTSTRAP = R"PY(
import ctypes

_libc = ctypes.CDLL(None)
_libc.fwrite.restype = ctypes.c_size_t
_libc.fwrite.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                         ctypes.c_size_t, ctypes.c_void_p]
_libc.fread.restype = ctypes.c_size_t
_libc.fread.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                        ctypes.c_size_t, ctypes.c_void_p]


class _FileSink:
    def __init__(self, fp):
        self.fp = fp
        self.written = 0

    def write(self, b):
        b = bytes(b)
        n = _libc.fwrite(b, 1, len(b), ctypes.c_void_p(self.fp))
        self.written += n
        return n


def _canon(transform, entropy):
    from kanzi_tpu_torch.entropy import factory as ef
    from kanzi_tpu_torch.transform import factory as tf
    t = tf.transform_type_to_name(tf.transform_name_to_type(transform))
    e = ef.entropy_type_to_name(ef.entropy_name_to_type(entropy))
    return t, e


def _init_compressor(fp, transform, entropy, block_size, jobs, checksum,
                     headerless):
    from kanzi_tpu_torch.io.compressed_stream import CompressedWriter
    t, e = _canon(transform, entropy)
    sink = _FileSink(fp)
    w = CompressedWriter(sink, transform=t, entropy=e,
                         block_size=block_size, checksum_bits=checksum,
                         headerless=bool(headerless), jobs=max(1, jobs))
    return {"w": w, "sink": sink, "names": (t, e)}


def _compress(st, data):
    st["w"].write(data)
    return st["sink"].written


def _dispose_compressor(st):
    st["w"].close()
    return st["sink"].written


def _init_decompressor(fp, buffer_size, jobs, headerless, transform,
                       entropy, block_size, original_size, bs_version):
    chunks = []
    buf = ctypes.create_string_buffer(1 << 20)
    while True:
        n = _libc.fread(buf, 1, len(buf), ctypes.c_void_p(fp))
        if n <= 0:
            break
        chunks.append(buf.raw[:n])
    blob = b"".join(chunks)
    from kanzi_tpu_torch.io.compressed_stream import CompressedReader
    kwargs = {}
    names = ("", "")
    if headerless:
        names = _canon(transform, entropy)
        kwargs = dict(headerless=True, transform=names[0],
                      entropy=names[1], block_size=block_size,
                      original_size=original_size, bs_version=bs_version)
    r = CompressedReader(blob, jobs=max(1, jobs), **kwargs)
    return {"r": r, "gen": r.read_blocks(), "pend": b"",
            "in": len(blob), "names": names}


def _decompress(st, want):
    out = st["pend"]
    while len(out) < want:
        try:
            out += next(st["gen"])
        except StopIteration:
            break
    st["pend"] = out[want:]
    consumed, st["in"] = st["in"], 0
    return out[:want], consumed
)PY";

namespace {

std::once_flag g_once;
PyObject* g_mod = nullptr;      // the bootstrap's module
bool g_ok = false;

void ensure_python() {
    std::call_once(g_once, [] {
        const bool started = !Py_IsInitialized();
        if (started) Py_InitializeEx(0);
        PyGILState_STATE gs = PyGILState_Ensure();
        const char* env = getenv("KANZI_TPU_PYROOT");
        const std::string root = (env && *env) ? env : KANZI_TPU_TORCH_PYROOT;
        PyObject* sys_path = PySys_GetObject("path");
        PyObject* r = PyUnicode_FromString(root.c_str());
        if (sys_path && r) PyList_Insert(sys_path, 0, r);
        Py_XDECREF(r);

        PyObject* mod = PyModule_New("_kanzi_tpu_torch_capi");
        PyObject* d = PyModule_GetDict(mod);
        PyDict_SetItemString(d, "__builtins__", PyEval_GetBuiltins());
        PyObject* res = PyRun_String(BOOTSTRAP, Py_file_input, d, d);
        if (res) {
            g_mod = mod;
            g_ok = true;
            Py_DECREF(res);
        } else {
            PyErr_Print();
            Py_DECREF(mod);
        }
        PyGILState_Release(gs);
        // the init thread holds the GIL from Py_InitializeEx on: give it
        // up, so that Python threads run between calls too
        if (started) PyEval_SaveThread();
    });
}

// map a raised KanziError to its numeric code (Error.hpp values);
// anything else -> 127
int error_code_from_exc() {
    int code = 127;
    if (getenv("KANZI_TPU_CAPI_DEBUG")) {
        PyErr_Print();                  // diagnostic mode: dump + clear
        return code;
    }
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    if (value) {
        PyObject* c = PyObject_GetAttrString(value, "code");
        if (c) {
            PyObject* v = PyObject_GetAttrString(c, "value");
            PyObject* num = v ? v : c;
            long l = PyLong_AsLong(num);
            if (l > 0 && l <= 127) code = (int)l;
            Py_XDECREF(v);
            Py_DECREF(c);
        }
        PyErr_Clear();
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
    PyErr_Clear();
    return code;
}

PyObject* call(const char* fn, PyObject* args) {
    PyObject* d = PyModule_GetDict(g_mod);
    PyObject* f = PyDict_GetItemString(d, fn);   // borrowed
    if (!f) return nullptr;
    return PyObject_CallObject(f, args);
}

void write_back_names(PyObject* st, char* transform, char* entropy,
                      size_t tcap, size_t ecap) {
    PyObject* names = PyDict_GetItemString(st, "names");
    if (!names || !PyTuple_Check(names)) return;
    const char* t = PyUnicode_AsUTF8(PyTuple_GetItem(names, 0));
    const char* e = PyUnicode_AsUTF8(PyTuple_GetItem(names, 1));
    if (t && *t) { strncpy(transform, t, tcap - 1); transform[tcap - 1] = 0; }
    if (e && *e) { strncpy(entropy, e, ecap - 1); entropy[ecap - 1] = 0; }
}

}  // namespace

extern "C" {

unsigned int getCompressorVersion(void) { return 0x010000; }
unsigned int getDecompressorVersion(void) { return 0x010000; }

int initCompressor(struct cData* p, FILE* dst, struct cContext** ctx) {
    if (!p || !dst || !ctx) return 1;          // ERR_MISSING_PARAM
    ensure_python();
    if (!g_ok) return 4;                       // ERR_CREATE_COMPRESSOR
    PyGILState_STATE gs = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(Kssniii)", (unsigned long long)(uintptr_t)dst, p->transform,
        p->entropy, (Py_ssize_t)p->blockSize, (int)p->jobs, p->checksum,
        p->headerless);
    PyObject* st = args ? call("_init_compressor", args) : nullptr;
    Py_XDECREF(args);
    if (!st) {
        int code = error_code_from_exc();
        PyGILState_Release(gs);
        return code ? code : 4;
    }
    write_back_names(st, p->transform, p->entropy,
                     sizeof(p->transform), sizeof(p->entropy));
    *ctx = new cContext{st, p->blockSize};
    PyGILState_Release(gs);
    return 0;
}

int compress(struct cContext* ctx, const unsigned char* src,
             size_t inSize, size_t* outSize) {
    if (!ctx || !ctx->st || !src || !outSize) return 1;
    if (inSize > ctx->blockSize) return 18;    // ERR_INVALID_PARAM
    PyGILState_STATE gs = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(Oy#)", ctx->st, (const char*)src, (Py_ssize_t)inSize);
    PyObject* r = args ? call("_compress", args) : nullptr;
    Py_XDECREF(args);
    if (!r) {
        int code = error_code_from_exc();
        PyGILState_Release(gs);
        return code ? code : 13;               // ERR_PROCESS_BLOCK
    }
    *outSize = (size_t)PyLong_AsSsize_t(r);
    Py_DECREF(r);
    PyGILState_Release(gs);
    return 0;
}

int disposeCompressor(struct cContext** ctx, size_t* outSize) {
    if (!ctx || !*ctx) return 1;
    PyGILState_STATE gs = PyGILState_Ensure();
    PyObject* args = Py_BuildValue("(O)", (*ctx)->st);
    PyObject* r = args ? call("_dispose_compressor", args) : nullptr;
    Py_XDECREF(args);
    int rc = 0;
    if (!r) {
        rc = error_code_from_exc();
        if (!rc) rc = 13;
    } else {
        if (outSize) *outSize = (size_t)PyLong_AsSsize_t(r);
        Py_DECREF(r);
    }
    Py_XDECREF((*ctx)->st);
    delete *ctx;
    *ctx = nullptr;
    PyGILState_Release(gs);
    return rc;
}

int initDecompressor(struct dData* p, FILE* src, struct dContext** ctx) {
    if (!p || !src || !ctx) return 1;
    ensure_python();
    if (!g_ok) return 5;                       // ERR_CREATE_DECOMPRESSOR
    PyGILState_STATE gs = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(Kniissini)", (unsigned long long)(uintptr_t)src,
        (Py_ssize_t)p->bufferSize, (int)p->jobs, p->headerless,
        p->transform, p->entropy, (int)p->blockSize,
        (Py_ssize_t)p->originalSize, p->bsVersion);
    PyObject* st = args ? call("_init_decompressor", args) : nullptr;
    Py_XDECREF(args);
    if (!st) {
        int code = error_code_from_exc();
        PyGILState_Release(gs);
        return code ? code : 5;
    }
    if (p->headerless)
        write_back_names(st, p->transform, p->entropy,
                         sizeof(p->transform), sizeof(p->entropy));
    *ctx = new dContext{st};
    PyGILState_Release(gs);
    return 0;
}

int decompress(struct dContext* ctx, unsigned char* dst, size_t* inSize,
               size_t* outSize) {
    if (!ctx || !ctx->st || !dst || !outSize) return 1;
    PyGILState_STATE gs = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(On)", ctx->st, (Py_ssize_t)*outSize);
    PyObject* r = args ? call("_decompress", args) : nullptr;
    Py_XDECREF(args);
    if (!r) {
        int code = error_code_from_exc();
        PyGILState_Release(gs);
        return code ? code : 13;
    }
    PyObject* data = PyTuple_GetItem(r, 0);
    PyObject* consumed = PyTuple_GetItem(r, 1);
    char* buf = nullptr;
    Py_ssize_t n = 0;
    PyBytes_AsStringAndSize(data, &buf, &n);
    if (n > 0) memcpy(dst, buf, (size_t)n);
    *outSize = (size_t)n;
    if (inSize) *inSize = (size_t)PyLong_AsSsize_t(consumed);
    Py_DECREF(r);
    PyGILState_Release(gs);
    return 0;
}

int disposeDecompressor(struct dContext** ctx) {
    if (!ctx || !*ctx) return 1;
    PyGILState_STATE gs = PyGILState_Ensure();
    Py_XDECREF((*ctx)->st);
    delete *ctx;
    *ctx = nullptr;
    PyGILState_Release(gs);
    return 0;
}

}  // extern "C"
