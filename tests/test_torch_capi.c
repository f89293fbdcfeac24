/* Script driver of the FILE* C API (native/kanzi_tpu_capi.h): runs many
 * compress and decompress calls in one process, so that the embedded
 * interpreter and torch start once. Built against either library (the
 * port's, kanzi_tpu_torch/csrc/capi.cpp, or kanzi_tpu's, native/capi.cpp)
 * by tests/test_torch_capi.py and chip_smoke.py.
 *
 *   test_torch_capi SCRIPT
 *
 * SCRIPT holds one command a line; each prints one line to stdout:
 *   c IN OUT TRANSFORM ENTROPY BLOCK JOBS CHECKSUM HEADERLESS
 *       compress IN to OUT, BLOCK bytes a compress() call
 *       -> "c RC INIT_RC BYTES_WRITTEN SECONDS TRANSFORM ENTROPY"
 *   d IN OUT JOBS HEADERLESS [TRANSFORM ENTROPY BLOCK SIZE CHECKSUM]
 *       decompress IN to OUT (the fields after HEADERLESS only when it
 *       is 1) -> "d RC BYTES_OUT SECONDS"
 *   o TRANSFORM ENTROPY BLOCK
 *       a compress() of BLOCK + 1 bytes -> "o INIT_RC RC DISPOSE_RC"
 *   m   NULL arguments -> "m RC RC RC RC RC RC"
 *   p MODULE
 *       print the COUNTERS dict of MODULE as JSON, through the embedded
 *       interpreter -> "p JSON"
 *   t MODULE FUNCTION
 *       call MODULE.FUNCTION() through the embedded interpreter (e.g.
 *       kanzi_tpu_torch.ops disable: the host path from the next
 *       command on) -> "t"
 * RC is the first non-zero code of the command's calls, 0 if none. */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "kanzi_tpu_capi.h"

static double now(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

static unsigned char* slurp(const char* path, size_t* n) {
    FILE* f = fopen(path, "rb");
    if (!f) return NULL;
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    fseek(f, 0, SEEK_SET);
    unsigned char* b = (unsigned char*)malloc(len > 0 ? (size_t)len : 1);
    *n = fread(b, 1, (size_t)len, f);
    fclose(f);
    return b;
}

static void do_compress(char* in, char* out, char* t, char* e, size_t bs,
                        unsigned jobs, int checksum, int headerless) {
    size_t n = 0;
    unsigned char* src = slurp(in, &n);
    struct cData cp;
    memset(&cp, 0, sizeof(cp));
    strncpy(cp.transform, t, sizeof(cp.transform) - 1);
    strncpy(cp.entropy, e, sizeof(cp.entropy) - 1);
    cp.blockSize = bs;
    cp.jobs = jobs;
    cp.checksum = checksum;
    cp.headerless = headerless;
    struct cContext* ctx = NULL;
    FILE* f = fopen(out, "wb");
    double t0 = now();
    int rc = src && f ? 0 : 2;
    int init_rc = rc ? rc : initCompressor(&cp, f, &ctx);
    rc = init_rc;
    size_t written = 0;
    for (size_t pos = 0; rc == 0 && pos < n; pos += bs) {
        size_t k = n - pos < bs ? n - pos : bs;
        rc = compress(ctx, src + pos, k, &written);
    }
    if (ctx) {
        int r = disposeCompressor(&ctx, &written);
        if (!rc) rc = r;
    }
    double dt = now() - t0;
    if (f) fclose(f);
    printf("c %d %d %zu %.6f %s %s\n", rc, init_rc, written, dt,
           cp.transform, cp.entropy);
    free(src);
}

static void do_decompress(char* in, char* out, unsigned jobs,
                          int headerless, char* t, char* e, unsigned bs,
                          size_t size, int checksum) {
    struct dData dp;
    memset(&dp, 0, sizeof(dp));
    dp.bufferSize = bs ? bs : (4u << 20);
    dp.jobs = jobs;
    dp.headerless = headerless;
    if (headerless) {
        strncpy(dp.transform, t, sizeof(dp.transform) - 1);
        strncpy(dp.entropy, e, sizeof(dp.entropy) - 1);
        dp.blockSize = bs;
        dp.originalSize = size;
        dp.checksum = checksum;
        dp.bsVersion = 6;
    }
    FILE* f = fopen(in, "rb");
    FILE* g = fopen(out, "wb");
    struct dContext* ctx = NULL;
    double t0 = now();
    int rc = f && g ? initDecompressor(&dp, f, &ctx) : 2;
    size_t chunk = dp.bufferSize, total = 0, used = 0;
    unsigned char* buf = (unsigned char*)malloc(chunk);
    while (rc == 0) {
        size_t want = chunk;
        rc = decompress(ctx, buf, &used, &want);
        if (rc || want == 0) break;
        fwrite(buf, 1, want, g);
        total += want;
    }
    if (ctx) {
        int r = disposeDecompressor(&ctx);
        if (!rc) rc = r;
    }
    double dt = now() - t0;
    if (f) fclose(f);
    if (g) fclose(g);
    free(buf);
    printf("d %d %zu %.6f\n", rc, total, dt);
}

static void do_oversized(char* t, char* e, size_t bs) {
    struct cData cp;
    memset(&cp, 0, sizeof(cp));
    strncpy(cp.transform, t, sizeof(cp.transform) - 1);
    strncpy(cp.entropy, e, sizeof(cp.entropy) - 1);
    cp.blockSize = bs;
    cp.jobs = 1;
    FILE* f = tmpfile();
    struct cContext* ctx = NULL;
    unsigned char* src = (unsigned char*)calloc(bs + 1, 1);
    size_t out = 0;
    int init_rc = initCompressor(&cp, f, &ctx);
    int rc = init_rc ? -1 : compress(ctx, src, bs + 1, &out);
    int dispose_rc = ctx ? disposeCompressor(&ctx, &out) : -1;
    printf("o %d %d %d\n", init_rc, rc, dispose_rc);
    fclose(f);
    free(src);
}

static void do_missing(void) {
    struct cData cp;
    struct dData dp;
    struct cContext* cctx = NULL;
    struct dContext* dctx = NULL;
    unsigned char b[4];
    size_t n = 4;
    memset(&cp, 0, sizeof(cp));
    memset(&dp, 0, sizeof(dp));
    printf("m %d %d %d %d %d %d\n", initCompressor(NULL, stdout, &cctx),
           initCompressor(&cp, NULL, &cctx), compress(NULL, b, n, &n),
           disposeCompressor(NULL, &n), initDecompressor(&dp, NULL, &dctx),
           decompress(NULL, b, &n, &n));
}

static void run_python(const char* code) {
    fflush(stdout);
    PyGILState_STATE gs = PyGILState_Ensure();
    PyRun_SimpleString(code);
    PyGILState_Release(gs);
}

static void do_call(const char* module, const char* fn) {
    char code[512];
    snprintf(code, sizeof(code),
             "import importlib, sys\n"
             "importlib.import_module('%s').%s()\n"
             "print('t')\nsys.stdout.flush()\n", module, fn);
    run_python(code);
}

static void do_counters(const char* module) {
    char code[512];
    snprintf(code, sizeof(code),
             "import json, sys, importlib\n"
             "print('p', json.dumps(importlib.import_module('%s').COUNTERS,"
             " sort_keys=True))\nsys.stdout.flush()\n", module);
    run_python(code);
}

int main(int argc, char** argv) {
    if (argc != 2) return 2;
    FILE* s = fopen(argv[1], "r");
    if (!s) return 2;
    char line[4096];
    while (fgets(line, sizeof(line), s)) {
        char* tok[16];
        int k = 0;
        for (char* p = strtok(line, " \t\n"); p && k < 16;
             p = strtok(NULL, " \t\n"))
            tok[k++] = p;
        if (k == 0) continue;
        if (!strcmp(tok[0], "c") && k == 9)
            do_compress(tok[1], tok[2], tok[3], tok[4],
                        (size_t)strtoull(tok[5], NULL, 10),
                        (unsigned)atoi(tok[6]), atoi(tok[7]), atoi(tok[8]));
        else if (!strcmp(tok[0], "d") && (k == 5 || k == 10))
            do_decompress(tok[1], tok[2], (unsigned)atoi(tok[3]),
                          atoi(tok[4]), k == 10 ? tok[5] : (char*)"",
                          k == 10 ? tok[6] : (char*)"",
                          k == 10 ? (unsigned)atoi(tok[7]) : 0,
                          k == 10 ? (size_t)strtoull(tok[8], NULL, 10) : 0,
                          k == 10 ? atoi(tok[9]) : 0);
        else if (!strcmp(tok[0], "o") && k == 4)
            do_oversized(tok[1], tok[2], (size_t)strtoull(tok[3], NULL, 10));
        else if (!strcmp(tok[0], "m"))
            do_missing();
        else if (!strcmp(tok[0], "p") && k == 2)
            do_counters(tok[1]);
        else if (!strcmp(tok[0], "t") && k == 3)
            do_call(tok[1], tok[2]);
        else
            printf("? %s\n", tok[0]);
        fflush(stdout);
    }
    fclose(s);
    return 0;
}
