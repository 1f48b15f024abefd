// Walker/Vose alias-table construction for O(1) categorical sampling.
//
// The port's own copy of the reference's builder
// (mitsuba_tpu/native/alias_table.cpp), kept identical below this note so
// that both packages build the same environment table from the same
// weights (tests/test_torch_envmap.py holds them equal).  The port
// compiles it with g++ at first use (mitsuba_tpu_torch/native.py
// load_host).
//
// Replaces per-lane binary CDF searches in the device sampling path
// (each search step is a serialized HBM gather on TPU — the alias
// method needs a single table row per draw).  The reference samples
// its environment map through hierarchical 2D CDFs
// (src/emitters/envmap.cpp sampleDirection); the alias formulation
// draws from the identical per-pixel density, so pdfs and MIS weights
// are unchanged.
//
// Build is O(n): two index stacks of under/over-full bins (Vose 1991).

#include <cstdint>
#include <vector>

extern "C" int mts_build_alias(const double* w, long long n,
                               float* prob, int32_t* alias) {
    if (n <= 0) return -1;
    double sum = 0.0;
    for (long long i = 0; i < n; ++i) sum += (w[i] > 0.0 ? w[i] : 0.0);
    std::vector<double> p(n);
    if (sum <= 0.0) {
        for (long long i = 0; i < n; ++i) p[i] = 1.0;
    } else {
        const double scale = double(n) / sum;
        for (long long i = 0; i < n; ++i)
            p[i] = (w[i] > 0.0 ? w[i] : 0.0) * scale;
    }

    std::vector<int32_t> small, large;
    small.reserve(n);
    large.reserve(n);
    for (long long i = 0; i < n; ++i) {
        alias[i] = int32_t(i);
        (p[i] < 1.0 ? small : large).push_back(int32_t(i));
    }
    while (!small.empty() && !large.empty()) {
        int32_t s = small.back();
        small.pop_back();
        int32_t l = large.back();
        large.pop_back();
        prob[s] = float(p[s]);
        alias[s] = l;
        p[l] = (p[l] + p[s]) - 1.0;
        (p[l] < 1.0 ? small : large).push_back(l);
    }
    // numerical leftovers: both stacks drain to probability 1
    while (!large.empty()) {
        prob[large.back()] = 1.0f;
        large.pop_back();
    }
    while (!small.empty()) {
        prob[small.back()] = 1.0f;
        small.pop_back();
    }
    return 0;
}
