/* Standalone C host exercising the port's native API end-to-end: proves
 * the library embeds the interpreter and runs a full VB fit through
 * fabber_core_tpu_torch with no Python on the host side. A copy of
 * capi/test_host.c (the reference binding flow, py/fabber.py:634-713,
 * from C) with three additions:
 *
 *   test_host [DEVICE]   DEVICE ("cuda", "cpu") is set as the option
 *                        `device`; with none, no device option is set
 *                        and the run takes the backend's default, the
 *                        card.
 *
 * The run is at dtype=single, and the host prints the seconds of
 * fabber_new (the embedded interpreter's start and the port's import)
 * and of fabber_dorun, the log's "Vb::Engine route:" line, then one
 * line naming the modules of jax or of the JAX package
 * (fabber_core_tpu) that the embedded interpreter holds after the run
 * ("none" for the port alone).
 *
 * Build: fabber_core_tpu_torch/capi/__init__.py build_host(). */

#include <Python.h>

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define NX 4
#define NY 3
#define NZ 2
#define NT 16
#define NV (NX * NY * NZ)

extern void *fabber_new(char *err_buf);
extern void fabber_destroy(void *fab);
extern int fabber_set_extent(void *fab, unsigned nx, unsigned ny, unsigned nz,
    const int *mask, char *err_buf);
extern int fabber_set_opt(void *fab, const char *key, const char *value,
    char *err_buf);
extern int fabber_set_data(void *fab, const char *name, unsigned data_size,
    const float *data, char *err_buf);
extern int fabber_dorun(void *fab, unsigned log_bufsize, char *log_buf,
    char *err_buf, void (*progress_cb)(int, int));
extern int fabber_get_data_size(void *fab, const char *name, char *err_buf);
extern int fabber_get_data(void *fab, const char *name, float *buf,
    char *err_buf);
extern int fabber_get_models(void *fab, unsigned bufsize, char *buf,
    char *err_buf);

static int progress_calls = 0;
static void on_progress(int voxel, int total)
{
    (void)voxel;
    (void)total;
    progress_calls++;
}

#define CHECK(expr)                                                            \
    do                                                                         \
    {                                                                          \
        int rc_ = (expr);                                                      \
        if (rc_ < 0)                                                           \
        {                                                                      \
            fprintf(stderr, "FAIL: %s -> %d (%s)\n", #expr, rc_, err);         \
            return 1;                                                          \
        }                                                                      \
    } while (0)

static double now_s(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

/* Print the log line that starts with `key` (up to its newline) */
static int print_log_line(const char *log, const char *key)
{
    const char *at = strstr(log, key);
    if (!at)
        return 0;
    const char *end = strchr(at, '\n');
    int len = end ? (int)(end - at) : (int)strlen(at);
    printf("%.*s\n", len, at);
    return 1;
}

/* The modules of jax or fabber_core_tpu in the embedded interpreter */
static int print_jax_modules(void)
{
    fflush(stdout); /* the interpreter writes through its own buffer */
    PyGILState_STATE gil = PyGILState_Ensure();
    int rc = PyRun_SimpleString(
        "import sys\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'fabber_core_tpu'))\n"
        "print('modules of jax or the JAX package:',\n"
        "      ' '.join(bad) if bad else 'none', flush=True)\n");
    PyGILState_Release(gil);
    return rc;
}

int main(int argc, char **argv)
{
    char err[256] = { 0 };
    char buf[4096] = { 0 };
    static char logbuf[1 << 20];

    double t0 = now_s();
    void *fab = fabber_new(err);
    if (!fab)
    {
        fprintf(stderr, "FAIL: fabber_new: %s\n", err);
        return 1;
    }
    printf("fabber_new: %.3f s\n", now_s() - t0);

    CHECK(fabber_get_models(fab, sizeof(buf), buf, err));
    if (!strstr(buf, "poly"))
    {
        fprintf(stderr, "FAIL: poly not in models: %s\n", buf);
        return 1;
    }

    CHECK(fabber_set_extent(fab, NX, NY, NZ, NULL, err));
    if (argc > 1)
        CHECK(fabber_set_opt(fab, "device", argv[1], err));
    CHECK(fabber_set_opt(fab, "model", "poly", err));
    CHECK(fabber_set_opt(fab, "degree", "1", err));
    CHECK(fabber_set_opt(fab, "method", "vb", err));
    CHECK(fabber_set_opt(fab, "noise", "white", err));
    CHECK(fabber_set_opt(fab, "max-iterations", "8", err));
    CHECK(fabber_set_opt(fab, "dtype", "single", err));
    CHECK(fabber_set_opt(fab, "save-mean", "", err));
    CHECK(fabber_set_opt(fab, "save-noise-mean", "", err));

    /* phantom: y = 2 + 0.5*t + small deterministic ripple */
    static float data[NV * NT];
    for (int t = 0; t < NT; t++)
        for (int v = 0; v < NV; v++)
            data[t * NV + v]
                = 2.0f + 0.5f * (t + 1) + 0.05f * sinf(v + t * 1.7f);
    CHECK(fabber_set_data(fab, "data", NT, data, err));

    t0 = now_s();
    CHECK(fabber_dorun(fab, sizeof(logbuf), logbuf, err, on_progress));
    printf("fabber_dorun: %.3f s\n", now_s() - t0);
    if (!print_log_line(logbuf, "Vb::Engine route:"))
    {
        fprintf(stderr, "FAIL: no route line in the log\n");
        return 1;
    }

    int size = fabber_get_data_size(fab, "mean_c1", err);
    CHECK(size);
    static float mean_c1[NV];
    CHECK(fabber_get_data(fab, "mean_c1", mean_c1, err));

    double sum = 0;
    for (int v = 0; v < NV; v++)
        sum += mean_c1[v];
    double avg = sum / NV;
    printf("mean_c1 avg = %.4f (true 0.5), progress calls = %d\n", avg,
        progress_calls);
    if (fabs(avg - 0.5) > 0.02 || progress_calls < 2)
    {
        fprintf(stderr, "FAIL: wrong recovery or no progress callbacks\n");
        return 1;
    }
    if (print_jax_modules() != 0)
    {
        fprintf(stderr, "FAIL: could not list the interpreter's modules\n");
        return 1;
    }

    fabber_destroy(fab);
    printf("C API host test PASSED\n");
    return 0;
}
