// n-step trajectory assembly, native (C++), the port's own copy of
// dist_dqn_tpu/actors/_native/assembler.cc.
//
// The Ape-X learner service folds every actor lane's step stream into
// n-step transitions; on the learner-side bootstrap path this replaces the
// per-step Python deque work of actors/assembler.py NStepAssembler with the
// same episode-boundary semantics:
//
//   * windows never span episodes: at a done, every open suffix window is
//     flushed with its shrunken horizon;
//   * terminal flushes carry discount 0; truncation flushes bootstrap from
//     the pre-reset successor observation with discount gamma^h;
//   * otherwise a full window (horizon n) emits with discount gamma^n.
//
// The return and the discount accumulate in double with a double gamma and
// are rounded to float once, as the Python assembler's float64 fold is, so
// the two emit the same bits (the JAX package's copy folds in float and
// agrees only to rounding).
//
// Copy discipline: lane rings hold pointers into the caller's step-record
// arrays (the Python wrapper keeps the last n_step+1 records alive), and
// emissions write exactly once into caller-registered output arenas (numpy
// arrays), which the replay insertion reads directly.
//
// Observations are opaque fixed-size byte blobs (dtype and shape live on
// the Python side). Built at first use with g++ (actors/transport.py
// build_native_lib), loaded through ctypes.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Lane {
  std::vector<const uint8_t*> obs;  // ring: n_step pointers
  std::vector<int32_t> action;      // ring: n_step
  std::vector<float> reward;        // ring: n_step
  int start = 0;
  int len = 0;
};

struct Assembler {
  int num_lanes;
  int n;
  double gamma;
  uint64_t obs_size;
  std::vector<Lane> lanes;
  // Caller-owned output arenas (registered once; numpy memory).
  uint8_t* arena_obs = nullptr;
  uint8_t* arena_next = nullptr;
  int32_t* arena_action = nullptr;
  float* arena_reward = nullptr;
  float* arena_discount = nullptr;
  int64_t capacity = 0;
  int64_t count = 0;      // emitted entries currently in the arena
  int64_t overflow = 0;   // emissions lost to a full arena (bug if != 0)
};

void emit(Assembler* a, Lane& lane, int horizon, const uint8_t* bootstrap,
          bool terminal) {
  if (a->count >= a->capacity) {
    a->overflow += 1;
    return;
  }
  double r = 0.0, g = 1.0;
  for (int k = 0; k < horizon; ++k) {
    r += g * static_cast<double>(lane.reward[(lane.start + k) % a->n]);
    g *= a->gamma;
  }
  const uint64_t sz = a->obs_size;
  const int64_t i = a->count;
  std::memcpy(a->arena_obs + i * sz, lane.obs[lane.start], sz);
  std::memcpy(a->arena_next + i * sz, bootstrap, sz);
  a->arena_action[i] = lane.action[lane.start];
  a->arena_reward[i] = static_cast<float>(r);
  a->arena_discount[i] = terminal ? 0.0f : static_cast<float>(g);
  a->count += 1;
}

inline void pop_front(Assembler* a, Lane& lane) {
  lane.start = (lane.start + 1) % a->n;
  lane.len -= 1;
}

}  // namespace

extern "C" {

void* dqn_asm_create(int num_lanes, int n_step, double gamma,
                     uint64_t obs_size) {
  auto* a = new Assembler();
  a->num_lanes = num_lanes;
  a->n = n_step;
  a->gamma = gamma;
  a->obs_size = obs_size;
  a->lanes.resize(num_lanes);
  for (auto& lane : a->lanes) {
    lane.obs.resize(n_step);
    lane.action.resize(n_step);
    lane.reward.resize(n_step);
  }
  return a;
}

void dqn_asm_destroy(void* h) { delete static_cast<Assembler*>(h); }

// Register the caller-owned output arenas (entry capacity, not bytes).
void dqn_asm_set_arena(void* h, uint8_t* obs, int32_t* action, float* reward,
                       float* discount, uint8_t* next_obs,
                       int64_t capacity) {
  auto* a = static_cast<Assembler*>(h);
  a->arena_obs = obs;
  a->arena_action = action;
  a->arena_reward = reward;
  a->arena_discount = discount;
  a->arena_next = next_obs;
  a->capacity = capacity;
  a->count = 0;
}

void dqn_asm_reset(void* h) {
  auto* a = static_cast<Assembler*>(h);
  for (auto& lane : a->lanes) {
    lane.start = 0;
    lane.len = 0;
  }
}

// One completed env step for every lane. The obs/next_obs memory must stay
// valid until the step after next drain of any window containing it — the
// Python wrapper guarantees this by keeping the last n_step+1 records
// alive.
void dqn_asm_step(void* h, const uint8_t* obs, const int32_t* action,
                  const float* reward, const uint8_t* terminated,
                  const uint8_t* truncated, const uint8_t* next_obs) {
  auto* a = static_cast<Assembler*>(h);
  const uint64_t sz = a->obs_size;
  for (int i = 0; i < a->num_lanes; ++i) {
    Lane& lane = a->lanes[i];
    const int slot = (lane.start + lane.len) % a->n;
    lane.obs[slot] = obs + i * sz;
    lane.action[slot] = action[i];
    lane.reward[slot] = reward[i];
    lane.len += 1;
    const bool term = terminated[i] != 0;
    const bool done = term || truncated[i] != 0;
    const uint8_t* boot = next_obs + i * sz;
    if (done) {
      while (lane.len > 0) {
        emit(a, lane, lane.len, boot, term);
        pop_front(a, lane);
      }
    } else if (lane.len == a->n) {
      emit(a, lane, a->n, boot, /*terminal=*/false);
      pop_front(a, lane);
    }
  }
}

int64_t dqn_asm_pending(void* h) {
  return static_cast<Assembler*>(h)->count;
}

int64_t dqn_asm_overflow(void* h) {
  return static_cast<Assembler*>(h)->overflow;
}

// The arena already holds the emitted entries; just hand back the count
// and reset the cursor (the caller consumes the arena slices first).
int64_t dqn_asm_take(void* h) {
  auto* a = static_cast<Assembler*>(h);
  const int64_t count = a->count;
  a->count = 0;
  return count;
}

}  // extern "C"
