// SMO solver for the C-SVC dual with RBF kernel.
//
// Native replacement for the reference's libsvm dependency (the SVM
// infinities classifier, gpry/svm.py wraps sklearn.svm.SVC): the fit is a
// small dense QP (n <= a few thousand points) solved on host once per
// iteration; the decision function is evaluated on the device (see
// gpry_tpu/models/classifier.py).
//
// Algorithm: standard SMO with maximal-violating-pair working-set
// selection (WSS1, as in libsvm's base strategy), full dense kernel cache
// (fine at these sizes), no shrinking.
//
//   minimize   0.5 a^T Q a - e^T a
//   subject to 0 <= a_i <= C,  y^T a = 0,   Q_ij = y_i y_j K(x_i, x_j)
//
// Build: g++ -O3 -march=native -fPIC -shared svc_smo.cpp -o libsvc_smo.so

#include <cmath>
#include <cstdlib>
#include <vector>

extern "C" {

// Returns the number of iterations used, or -1 on error.
// X: n*d row-major; y01: 0/1 labels; alpha_out: n (signed dual coefs
// alpha_i * y_i); b_out: intercept of the decision function
// f(x) = sum_i alpha_out[i] K(x, x_i) + b.
int svc_train_rbf(const double* X, const int* y01, int n, int d,
                  double C, double gamma, double tol, long max_iter,
                  double* alpha_out, double* b_out) {
    if (n <= 0 || d <= 0 || C <= 0 || gamma <= 0) return -1;

    std::vector<double> y(n);
    for (int i = 0; i < n; ++i) y[i] = y01[i] ? 1.0 : -1.0;

    // Dense kernel matrix (n^2 doubles; n <= few thousand -> <= ~100 MB).
    std::vector<double> K((size_t)n * n);
    std::vector<double> sq(n);
    for (int i = 0; i < n; ++i) {
        double s = 0.0;
        const double* xi = X + (size_t)i * d;
        for (int k = 0; k < d; ++k) s += xi[k] * xi[k];
        sq[i] = s;
    }
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        K[(size_t)i * n + i] = 1.0;
        for (int j = i + 1; j < n; ++j) {
            const double* xj = X + (size_t)j * d;
            double dot = 0.0;
            for (int k = 0; k < d; ++k) dot += xi[k] * xj[k];
            double val = std::exp(-gamma * (sq[i] + sq[j] - 2.0 * dot));
            K[(size_t)i * n + j] = val;
            K[(size_t)j * n + i] = val;
        }
    }

    std::vector<double> alpha(n, 0.0);
    // G_i = grad of the dual objective = sum_j Q_ij a_j - 1
    std::vector<double> G(n, -1.0);

    long it = 0;
    if (max_iter <= 0) max_iter = 200L * n > 100000L ? 200L * n : 100000L;
    for (; it < max_iter; ++it) {
        // WSS1: i = argmax_{t in I_up} -y_t G_t ; j = argmin_{t in I_low}
        int i = -1, j = -1;
        double gmax = -1e300, gmin = 1e300;
        for (int t = 0; t < n; ++t) {
            bool in_up = (y[t] > 0 && alpha[t] < C) ||
                         (y[t] < 0 && alpha[t] > 0);
            bool in_low = (y[t] > 0 && alpha[t] > 0) ||
                          (y[t] < 0 && alpha[t] < C);
            double v = -y[t] * G[t];
            if (in_up && v > gmax) { gmax = v; i = t; }
            if (in_low && v < gmin) { gmin = v; j = t; }
        }
        if (i < 0 || j < 0 || gmax - gmin < tol) break;

        // Analytic update of the (i, j) pair.
        const double* Ki = &K[(size_t)i * n];
        const double* Kj = &K[(size_t)j * n];
        double quad = Ki[i] + Kj[j] - 2.0 * Ki[j];
        if (quad <= 1e-12) quad = 1e-12;
        double delta = (gmax - gmin) / quad;   // step along y_i e_i - y_j e_j
        double ai_old = alpha[i], aj_old = alpha[j];
        double ai = ai_old + y[i] * delta;
        double aj = aj_old - y[j] * delta;

        // Clip to the box, preserving y^T a = 0.
        double lo_i = 0.0, hi_i = C;
        if (ai < lo_i) ai = lo_i;
        if (ai > hi_i) ai = hi_i;
        double shift = y[i] * (ai - ai_old);
        aj = aj_old - y[j] * shift;
        if (aj < 0.0) { aj = 0.0; }
        if (aj > C)   { aj = C; }
        shift = -y[j] * (aj - aj_old);
        ai = ai_old + y[i] * shift;
        if (ai < 0.0) ai = 0.0;
        if (ai > C) ai = C;

        double dai = (ai - ai_old) * y[i];
        double daj = (aj - aj_old) * y[j];
        if (std::fabs(dai) < 1e-300 && std::fabs(daj) < 1e-300) break;
        alpha[i] = ai;
        alpha[j] = aj;
        for (int t = 0; t < n; ++t)
            G[t] += y[t] * (Ki[t] * dai + Kj[t] * daj);
    }

    // Intercept from the KKT conditions (midpoint of the violating gap of
    // the free points, libsvm's rho with opposite sign convention).
    double b_sum = 0.0;
    int b_cnt = 0;
    double gmax = -1e300, gmin = 1e300;
    for (int t = 0; t < n; ++t) {
        double v = -y[t] * G[t];
        bool in_up = (y[t] > 0 && alpha[t] < C) ||
                     (y[t] < 0 && alpha[t] > 0);
        bool in_low = (y[t] > 0 && alpha[t] > 0) ||
                      (y[t] < 0 && alpha[t] < C);
        if (alpha[t] > 0.0 && alpha[t] < C) { b_sum += v; ++b_cnt; }
        if (in_up && v > gmax) gmax = v;
        if (in_low && v < gmin) gmin = v;
    }
    *b_out = b_cnt ? b_sum / b_cnt : 0.5 * (gmax + gmin);
    for (int t = 0; t < n; ++t) alpha_out[t] = alpha[t] * y[t];
    return (int)it;
}

}  // extern "C"
