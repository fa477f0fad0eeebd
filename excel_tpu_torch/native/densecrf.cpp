// Fully-connected CRF mean-field inference with permutohedral-lattice
// Gaussian filtering.
//
// TPU-native equivalent of the reference's pydensecrf dependency
// (reference utils/dcrf.py:1-68): same model — softmax-unary + Gaussian
// pairwise (x,y) + bilateral pairwise (x,y,r,g,b), Potts compatibility,
// symmetric kernel normalization, N mean-field iterations. Implemented
// from the published algorithms (Adams et al., "Fast High-Dimensional
// Filtering Using the Permutohedral Lattice", 2010; Krähenbühl & Koltun,
// "Efficient Inference in Fully Connected CRFs", 2011); no third-party
// code. Runs host-side over batches while the TPU computes the next batch.
//
// Build: g++ -O3 -shared -fPIC -o libexcelcrf.so densecrf.cpp
// C API at the bottom; ctypes binding in ../crf.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

// OpenMP parallelism is restricted to loops whose iterations write disjoint
// outputs or only read (splat-by-lattice-point, blur, slice, pointwise
// maps, lattice construction pass 1, neighbor lookups) — results are
// bit-identical for any thread count. The splat is parallelized over
// LATTICE POINTS via a reverse index built at init: each point's
// contributions are summed by exactly one thread in pixel order — the
// identical float-addition order the serial pixel-major splat produced, so
// the output is bit-equal to the serial version too. Only hash-table
// insertion stays serial (lattice-point numbering determinism).
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Permutohedral lattice filter
// ---------------------------------------------------------------------------

// flat open-addressing hash of short[d] keys -> dense indices (a
// std::unordered_map over vector<short> keys allocates per lookup and
// dominates lattice construction)
class KeyTable {
  public:
    KeyTable(int key_size, size_t expected)
        : key_size_(key_size) {
        capacity_ = 16;
        while (capacity_ < expected * 2) capacity_ <<= 1;
        slots_.assign(capacity_, -1);
        keys_.reserve(expected * key_size / 4);
    }

    int size() const { return static_cast<int>(keys_.size() / key_size_); }
    const short* key(int idx) const { return &keys_[idx * key_size_]; }

    // returns the dense index, inserting if `create`; -1 if absent
    int lookup(const short* k, bool create) {
        size_t h = hash(k) & (capacity_ - 1);
        while (true) {
            int e = slots_[h];
            if (e == -1) {
                if (!create) return -1;
                int idx = size();
                keys_.insert(keys_.end(), k, k + key_size_);
                slots_[h] = idx;
                return idx;
            }
            if (std::memcmp(key(e), k, key_size_ * sizeof(short)) == 0)
                return e;
            h = (h + 1) & (capacity_ - 1);
        }
    }

  private:
    size_t hash(const short* k) const {
        size_t h = 0;
        for (int i = 0; i < key_size_; ++i)
            h = h * 2531011u + static_cast<size_t>(k[i] + 32768);
        return h;
    }

    int key_size_;
    size_t capacity_;
    std::vector<int> slots_;
    std::vector<short> keys_;
};

class Permutohedral {
  public:
    // features: [N, d] row-major
    void init(const float* features, int N, int d) {
        N_ = N;
        d_ = d;
        offsets_.assign(static_cast<size_t>(N) * (d + 1), 0);
        barycentric_.assign(static_cast<size_t>(N) * (d + 1), 0.f);

        std::vector<float> scale(d);
        const float inv_std = std::sqrt(2.0f / 3.0f) * (d + 1);
        for (int i = 0; i < d; ++i)
            scale[i] = inv_std / std::sqrt(float(i + 1) * (i + 2));

        // worst case every splat target is a distinct lattice point:
        // N*(d+1) entries; size the table for that so probing terminates
        KeyTable table(d, static_cast<size_t>(N) * (d + 1));

        // pass 1 (parallel): per-pixel simplex geometry — barycentric
        // weights and the d+1 splat-target keys, staged into a flat buffer
        std::vector<short> all_keys(static_cast<size_t>(N) * (d + 1) * d);

#ifdef _OPENMP
#pragma omp parallel
#endif
        {
            std::vector<float> elevated(d + 1), rem0(d + 1), bary(d + 2);
            std::vector<int> rank(d + 1);

#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
            for (int n = 0; n < N; ++n) {
                const float* f = features + static_cast<size_t>(n) * d;
                // embed into the hyperplane sum(x)=0 in R^{d+1}
                float sm = 0.f;
                for (int i = d; i > 0; --i) {
                    float cf = f[i - 1] * scale[i - 1];
                    elevated[i] = sm - i * cf;
                    sm += cf;
                }
                elevated[0] = sm;

                // nearest remainder-0 lattice point (multiples of d+1)
                const float down = 1.0f / (d + 1);
                int sum = 0;
                for (int i = 0; i <= d; ++i) {
                    float v = elevated[i] * down;
                    int up = static_cast<int>(std::ceil(v)) * (d + 1);
                    int lo = static_cast<int>(std::floor(v)) * (d + 1);
                    int r = (up - elevated[i] < elevated[i] - lo) ? up : lo;
                    rem0[i] = static_cast<float>(r);
                    sum += r / (d + 1);
                }

                // rank differential; fix points outside the canonical simplex
                std::fill(rank.begin(), rank.end(), 0);
                for (int i = 0; i < d; ++i)
                    for (int j = i + 1; j <= d; ++j)
                        if (elevated[i] - rem0[i] < elevated[j] - rem0[j])
                            ++rank[i];
                        else
                            ++rank[j];
                for (int i = 0; i <= d; ++i) {
                    rank[i] += sum;
                    if (rank[i] < 0) {
                        rank[i] += d + 1;
                        rem0[i] += d + 1;
                    } else if (rank[i] > d) {
                        rank[i] -= d + 1;
                        rem0[i] -= d + 1;
                    }
                }

                // barycentric coordinates
                std::fill(bary.begin(), bary.end(), 0.f);
                for (int i = 0; i <= d; ++i) {
                    float v = (elevated[i] - rem0[i]) * down;
                    bary[d - rank[i]] += v;
                    bary[d - rank[i] + 1] -= v;
                }
                bary[0] += 1.0f + bary[d + 1];

                // splat targets: the d+1 simplex vertices. Canonical vertex
                // `rem` adds rem to every coordinate, minus (d+1) on the
                // coordinates whose rank >= d+1-rem (keeps the key sum 0).
                for (int rem = 0; rem <= d; ++rem) {
                    short* key = &all_keys[
                        (static_cast<size_t>(n) * (d + 1) + rem) * d];
                    for (int i = 0; i < d; ++i)
                        key[i] = static_cast<short>(rem0[i]) +
                                 ((rank[i] >= d + 1 - rem)
                                      ? static_cast<short>(rem - (d + 1))
                                      : static_cast<short>(rem));
                    barycentric_[static_cast<size_t>(n) * (d + 1) + rem] =
                        bary[rem];
                }
            }
        }

        // pass 2 (serial): hash insertion in pixel order — lattice-point
        // numbering identical to the single-threaded construction
        for (size_t s = 0; s < static_cast<size_t>(N) * (d + 1); ++s)
            offsets_[s] = table.lookup(&all_keys[s * d], true);

        M_ = table.size();

        // reverse index: per lattice point, its splat entries s = n*(d+1)+r
        // in increasing s (counting sort) — drives the parallel splat
        rev_start_.assign(M_ + 1, 0);
        const size_t total = static_cast<size_t>(N) * (d + 1);
        for (size_t s = 0; s < total; ++s) ++rev_start_[offsets_[s] + 1];
        for (int o = 0; o < M_; ++o) rev_start_[o + 1] += rev_start_[o];
        rev_entry_.resize(total);
        {
            std::vector<int> cursor(rev_start_.begin(), rev_start_.end() - 1);
            for (size_t s = 0; s < total; ++s)
                rev_entry_[cursor[offsets_[s]]++] = static_cast<int>(s);
        }

        // blur neighbor table: for each axis j and lattice point, the
        // indices of key +/- unit along that axis (read-only lookups)
        blur_n1_.assign(static_cast<size_t>(M_) * (d + 1), -1);
        blur_n2_.assign(static_cast<size_t>(M_) * (d + 1), -1);
#ifdef _OPENMP
#pragma omp parallel
#endif
        {
            std::vector<short> np1(d), nm1(d);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
            for (int idx = 0; idx < M_; ++idx) {
                const short* k = table.key(idx);
                for (int j = 0; j <= d; ++j) {
                    for (int i = 0; i < d; ++i) {
                        np1[i] = static_cast<short>(k[i] + 1);
                        nm1[i] = static_cast<short>(k[i] - 1);
                    }
                    if (j < d) {
                        np1[j] = static_cast<short>(k[j] - d);
                        nm1[j] = static_cast<short>(k[j] + d);
                    }
                    blur_n1_[static_cast<size_t>(j) * M_ + idx] =
                        table.lookup(np1.data(), false);
                    blur_n2_[static_cast<size_t>(j) * M_ + idx] =
                        table.lookup(nm1.data(), false);
                }
            }
        }
    }

    // out[N, vd] = filter(in[N, vd]); out may alias in (copied internally).
    // Lattice-value buffers are members reused across calls: mean-field
    // runs 2 kernels x n_iter filterings and the two ~M*vd float buffers
    // (tens of MB at VOC resolution) otherwise get re-allocated and
    // page-faulted 20x per image.
    void compute(float* __restrict out, const float* __restrict in,
                 int vd) const {
        vals_.assign(static_cast<size_t>(M_ + 1) * vd, 0.f);
        newv_.resize(static_cast<size_t>(M_ + 1) * vd);

        // splat. Two bit-identical orders: the serial pixel-major stream
        // (best cache behavior on one thread) and, with >1 OMP threads, a
        // parallel loop over lattice points whose per-point contributions
        // are summed in increasing splat-entry order — exactly the
        // additions the serial loop performs for that point, in the same
        // order, so the result is bit-equal for any thread count.
        const int* __restrict offs = offsets_.data();
        const float* __restrict bary = barycentric_.data();
        int threads = 1;
#ifdef _OPENMP
        threads = omp_get_max_threads();
#endif
        if (threads <= 1) {
            for (int n = 0; n < N_; ++n)
                for (int r = 0; r <= d_; ++r) {
                    int o = offs[static_cast<size_t>(n) * (d_ + 1) + r];
                    float w = bary[static_cast<size_t>(n) * (d_ + 1) + r];
                    float* __restrict dst =
                        &vals_[static_cast<size_t>(o) * vd];
                    const float* __restrict src =
                        in + static_cast<size_t>(n) * vd;
                    for (int c = 0; c < vd; ++c) dst[c] += w * src[c];
                }
        } else {
            const int* __restrict rstart = rev_start_.data();
            const int* __restrict rentry = rev_entry_.data();
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1024)
#endif
            for (int o = 0; o < M_; ++o) {
                float* __restrict dst = &vals_[static_cast<size_t>(o) * vd];
                for (int e = rstart[o]; e < rstart[o + 1]; ++e) {
                    const size_t s = static_cast<size_t>(rentry[e]);
                    const float w = bary[s];
                    const float* __restrict src =
                        in + (s / (d_ + 1)) * static_cast<size_t>(vd);
                    for (int c = 0; c < vd; ++c) dst[c] += w * src[c];
                }
            }
        }

        // blur along each lattice direction: v <- (n1 + 2 v + n2) / 2
        for (int j = 0; j <= d_; ++j) {
            const int* __restrict n1 = &blur_n1_[static_cast<size_t>(j) * M_];
            const int* __restrict n2 = &blur_n2_[static_cast<size_t>(j) * M_];
            const float* __restrict vsrc = vals_.data();
            float* __restrict vdst = newv_.data();
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
            for (int i = 0; i < M_; ++i) {
                const int i1 = n1[i];
                const int i2 = n2[i];
                const float* v = vsrc + static_cast<size_t>(i) * vd;
                const float* v1 = i1 < 0 ? nullptr
                                         : vsrc + static_cast<size_t>(i1) * vd;
                const float* v2 = i2 < 0 ? nullptr
                                         : vsrc + static_cast<size_t>(i2) * vd;
                float* o = vdst + static_cast<size_t>(i) * vd;
                if (v1 && v2) {
                    for (int c = 0; c < vd; ++c)
                        o[c] = (v1[c] + 2.f * v[c] + v2[c]) * 0.5f;
                } else {
                    for (int c = 0; c < vd; ++c) {
                        float a = v1 ? v1[c] : 0.f;
                        float b = v2 ? v2[c] : 0.f;
                        o[c] = (a + 2.f * v[c] + b) * 0.5f;
                    }
                }
            }
            vals_.swap(newv_);
        }

        // slice
        const float alpha = 1.0f / (1.0f + std::pow(2.0f, -d_));
        const float* __restrict vsrc = vals_.data();
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int n = 0; n < N_; ++n) {
            float* __restrict dst = out + static_cast<size_t>(n) * vd;
            for (int c = 0; c < vd; ++c) dst[c] = 0.f;
            for (int r = 0; r <= d_; ++r) {
                int o = offs[static_cast<size_t>(n) * (d_ + 1) + r];
                float w = alpha * bary[static_cast<size_t>(n) * (d_ + 1) + r];
                const float* __restrict src = vsrc + static_cast<size_t>(o) * vd;
                for (int c = 0; c < vd; ++c) dst[c] += w * src[c];
            }
        }
    }

  private:
    int N_ = 0, d_ = 0, M_ = 0;
    std::vector<int> offsets_;
    std::vector<float> barycentric_;
    std::vector<int> rev_start_, rev_entry_;
    std::vector<int> blur_n1_, blur_n2_;
    mutable std::vector<float> vals_, newv_;
};

// ---------------------------------------------------------------------------
// mean-field CRF
// ---------------------------------------------------------------------------

struct Kernel {
    Permutohedral lattice;
    std::vector<float> norm;   // symmetric normalization 1/sqrt(filter(1))
    float weight;

    void build(const float* features, int N, int d, float w) {
        weight = w;
        lattice.init(features, N, d);
        std::vector<float> ones(N, 1.f), filtered(N, 0.f);
        lattice.compute(filtered.data(), ones.data(), 1);
        norm.resize(N);
        for (int i = 0; i < N; ++i)
            norm[i] = 1.0f / std::sqrt(std::max(filtered[i], 1e-20f));
    }

    // msg[N, C] += weight * norm .* filter(norm .* Q)
    void add_message(std::vector<float>& msg, const std::vector<float>& Q,
                     int N, int C, std::vector<float>& scratch,
                     std::vector<float>& scratch2) const {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int i = 0; i < N; ++i)
            for (int c = 0; c < C; ++c)
                scratch[static_cast<size_t>(i) * C + c] =
                    Q[static_cast<size_t>(i) * C + c] * norm[i];
        lattice.compute(scratch2.data(), scratch.data(), C);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int i = 0; i < N; ++i)
            for (int c = 0; c < C; ++c)
                msg[static_cast<size_t>(i) * C + c] +=
                    weight * norm[i] *
                    scratch2[static_cast<size_t>(i) * C + c];
    }
};

void exp_normalize(std::vector<float>& Q, const std::vector<float>& logits,
                   int N, int C) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int i = 0; i < N; ++i) {
        const float* l = &logits[static_cast<size_t>(i) * C];
        float mx = l[0];
        for (int c = 1; c < C; ++c) mx = std::max(mx, l[c]);
        float sum = 0.f;
        float* q = &Q[static_cast<size_t>(i) * C];
        for (int c = 0; c < C; ++c) {
            q[c] = std::exp(l[c] - mx);
            sum += q[c];
        }
        for (int c = 0; c < C; ++c) q[c] /= sum;
    }
}

}  // namespace

extern "C" {

// image: [H, W, 3] uint8 RGB; probs/out: [C, H, W] float32.
// Mean-field with Potts potentials matching reference utils/dcrf.py:42-68:
//   Q <- softmax(-U + pos_w * G_pos(Q) + bi_w * G_bi(Q))
// (pydensecrf's tmp1 -= PottsCompatibility(-w) convention).
void excel_dcrf_inference(const uint8_t* image, const float* probs,
                          float* out, int H, int W, int C, int n_iters,
                          float pos_w, float pos_xy_std, float bi_w,
                          float bi_xy_std, float bi_rgb_std) {
    const int N = H * W;

    // unary = -log(prob) (unary_from_softmax, clamped like pydensecrf)
    std::vector<float> neg_unary(static_cast<size_t>(N) * C);
    for (int c = 0; c < C; ++c)
        for (int i = 0; i < N; ++i)
            neg_unary[static_cast<size_t>(i) * C + c] =
                std::log(std::max(probs[static_cast<size_t>(c) * N + i],
                                  1e-20f));

    Kernel pos, bi;
    {
        std::vector<float> f(static_cast<size_t>(N) * 2);
        for (int y = 0; y < H; ++y)
            for (int x = 0; x < W; ++x) {
                f[static_cast<size_t>(y * W + x) * 2 + 0] = x / pos_xy_std;
                f[static_cast<size_t>(y * W + x) * 2 + 1] = y / pos_xy_std;
            }
        pos.build(f.data(), N, 2, pos_w);
    }
    {
        std::vector<float> f(static_cast<size_t>(N) * 5);
        for (int y = 0; y < H; ++y)
            for (int x = 0; x < W; ++x) {
                size_t i = static_cast<size_t>(y * W + x);
                f[i * 5 + 0] = x / bi_xy_std;
                f[i * 5 + 1] = y / bi_xy_std;
                f[i * 5 + 2] = image[i * 3 + 0] / bi_rgb_std;
                f[i * 5 + 3] = image[i * 3 + 1] / bi_rgb_std;
                f[i * 5 + 4] = image[i * 3 + 2] / bi_rgb_std;
            }
        bi.build(f.data(), N, 5, bi_w);
    }

    std::vector<float> Q(static_cast<size_t>(N) * C);
    std::vector<float> logits(static_cast<size_t>(N) * C);
    std::vector<float> s1(static_cast<size_t>(N) * C),
        s2(static_cast<size_t>(N) * C);

    exp_normalize(Q, neg_unary, N, C);
    for (int it = 0; it < n_iters; ++it) {
        logits = neg_unary;
        pos.add_message(logits, Q, N, C, s1, s2);
        bi.add_message(logits, Q, N, C, s1, s2);
        exp_normalize(Q, logits, N, C);
    }

    for (int c = 0; c < C; ++c)
        for (int i = 0; i < N; ++i)
            out[static_cast<size_t>(c) * N + i] =
                Q[static_cast<size_t>(i) * C + c];
}

}  // extern "C"
