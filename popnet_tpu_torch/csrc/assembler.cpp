// Greedy multi-person limb assembly on the host: the port's own copy of
// the JAX package's native assembler, the default assembly of the
// Open-Pose+ evaluation's host route (cli/evaluate.py, use_native=True).
//
// Consumes the fixed-size (B, L, M, M) candidate scores and flags that the
// device scored (K1, K3) and runs the reference's greedy 1-1 limb
// assignment and union-merge (reference: lib/pafprocess/pafprocess.cpp and
// the find_connected_joints/group_limbs_of_same_person of
// lib/utils/paf_to_pose.py). The arithmetic is float32, as in the JAX
// package's copy: a person's score is a float sum, and it is kept when
// `score / count >= min_score` in float32; candidates are taken in the
// order of std::stable_sort on their score. People are filtered first, and
// the output stops at `max_people` rows a frame, which the NumPy assembler
// (decode/assemble.py) does not do.
//
// C interface (ctypes, popnet_tpu_torch/native/__init__.py):
//   popnet_assemble_batch(B, K, L, M, max_people, limbs, peaks, peak_valid,
//                         scores, ok, min_score, min_parts, out_joints,
//                         out_counts)
// Built with the host C++ compiler at first use (ops/_build.host_library).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Candidate {
  int i, j;
  float score;
};

struct Person {
  std::vector<int> ids;  // per joint: peak slot or -1
  float score = 0.f;
  int count = 0;
};

void assemble_one(
    int num_joints, int num_limbs, int max_peaks, int max_people,
    const int32_t* limbs, const float* peaks, const uint8_t* peak_valid,
    const float* scores, const uint8_t* ok, float min_score, int min_parts,
    float* out_joints, int32_t* out_count) {
  const int M = max_peaks;

  std::vector<int> n_peaks(num_joints, 0);
  for (int k = 0; k < num_joints; ++k)
    for (int m = 0; m < M; ++m) n_peaks[k] += peak_valid[k * M + m] ? 1 : 0;

  std::vector<Person> people;
  std::vector<Candidate> cand;
  std::vector<char> used_i(M), used_j(M);

  for (int l = 0; l < num_limbs; ++l) {
    const int src_t = limbs[2 * l];
    const int dst_t = limbs[2 * l + 1];
    const int ns = n_peaks[src_t], nd = n_peaks[dst_t];
    if (ns == 0 || nd == 0) continue;

    cand.clear();
    const float* sc = scores + (size_t)l * M * M;
    const uint8_t* okl = ok + (size_t)l * M * M;
    for (int i = 0; i < ns; ++i)
      for (int j = 0; j < nd; ++j)
        if (okl[i * M + j]) cand.push_back({i, j, sc[i * M + j]});
    std::stable_sort(cand.begin(), cand.end(),
                     [](const Candidate& a, const Candidate& b) {
                       return a.score > b.score;
                     });

    std::fill(used_i.begin(), used_i.end(), 0);
    std::fill(used_j.begin(), used_j.end(), 0);
    int n_conn = 0;
    const int max_conn = std::min(ns, nd);

    for (const auto& c : cand) {
      if (n_conn >= max_conn) break;
      if (used_i[c.i] || used_j[c.j]) continue;
      used_i[c.i] = used_j[c.j] = 1;
      ++n_conn;

      const float src_score = peaks[(src_t * M + c.i) * 3 + 2];
      const float dst_score = peaks[(dst_t * M + c.j) * 3 + 2];

      int a0 = -1, a1 = -1;
      for (size_t p = 0; p < people.size(); ++p) {
        if (people[p].ids[src_t] == c.i || people[p].ids[dst_t] == c.j) {
          if (a0 < 0)
            a0 = (int)p;
          else if (a1 < 0)
            a1 = (int)p;
        }
      }

      if (a0 >= 0 && a1 < 0) {
        Person& pr = people[a0];
        if (pr.ids[dst_t] != c.j) {
          pr.ids[dst_t] = c.j;
          pr.count += 1;
          pr.score += dst_score + c.score;
        }
      } else if (a0 >= 0 && a1 >= 0) {
        Person& p1 = people[a0];
        Person& p2 = people[a1];
        bool overlap = false;
        for (int k = 0; k < num_joints; ++k)
          if (p1.ids[k] >= 0 && p2.ids[k] >= 0) {
            overlap = true;
            break;
          }
        if (!overlap) {
          for (int k = 0; k < num_joints; ++k)
            p1.ids[k] += p2.ids[k] + 1;
          p1.score += p2.score + c.score;
          p1.count += p2.count;
          people.erase(people.begin() + a1);
        } else {
          p1.ids[dst_t] = c.j;
          p1.count += 1;
          p1.score += dst_score + c.score;
        }
      } else {
        Person pr;
        pr.ids.assign(num_joints, -1);
        pr.ids[src_t] = c.i;
        pr.ids[dst_t] = c.j;
        pr.count = 2;
        pr.score = src_score + dst_score + c.score;
        people.push_back(std::move(pr));
      }
    }
  }

  int n_out = 0;
  for (const auto& pr : people) {
    if (pr.count < min_parts || pr.score / pr.count < min_score) continue;
    if (n_out >= max_people) break;
    float* row = out_joints + (size_t)n_out * num_joints * 3;
    for (int k = 0; k < num_joints; ++k) {
      if (pr.ids[k] < 0) {
        row[k * 3 + 0] = -1.f;
        row[k * 3 + 1] = -1.f;
        row[k * 3 + 2] = 0.f;
      } else {
        const float* pk = peaks + ((size_t)k * M + pr.ids[k]) * 3;
        row[k * 3 + 0] = pk[0];
        row[k * 3 + 1] = pk[1];
        row[k * 3 + 2] = pk[2];
      }
    }
    ++n_out;
  }
  *out_count = n_out;
}

}  // namespace

extern "C" {

int popnet_assemble_batch(
    int batch, int num_joints, int num_limbs, int max_peaks, int max_people,
    const int32_t* limbs, const float* peaks, const uint8_t* peak_valid,
    const float* scores, const uint8_t* ok, float min_score, int min_parts,
    float* out_joints, int32_t* out_counts) {
  const size_t pk_stride = (size_t)num_joints * max_peaks;
  const size_t sc_stride = (size_t)num_limbs * max_peaks * max_peaks;
  const size_t out_stride = (size_t)max_people * num_joints * 3;
  std::memset(out_joints, 0, sizeof(float) * out_stride * batch);
  for (int b = 0; b < batch; ++b) {
    assemble_one(num_joints, num_limbs, max_peaks, max_people, limbs,
                 peaks + b * pk_stride * 3, peak_valid + b * pk_stride,
                 scores + b * sc_stride, ok + b * sc_stride, min_score,
                 min_parts, out_joints + b * out_stride, out_counts + b);
  }
  return 0;
}

}  // extern "C"
