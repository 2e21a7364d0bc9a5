// Circuit graph builder + level scheduler + wire-slot allocator.
//
// The runtime evaluates boolean circuits as a sequence of LEVELS, each a
// single batched bootstrap over all gates whose inputs are ready.  Wide
// levels = wide batched matmuls, so the scheduler's job is (1) ASAP
// topological leveling of the gate DAG, (2) liveness-based wire-slot reuse
// so the Python side can evaluate with a fixed int32[n_slots, n+1] arena
// instead of per-wire allocations.
//
// The reference has no analog (it evaluates circuits strictly sequentially,
// examples/add_two_numbers.zig:66-70); this is new batched runtime.
//
// Exposed as a C ABI for ctypes (zig_tfhe_jax/models/scheduler.py) and as a
// small CLI that consumes Bristol-fashion circuit files.
//
// Build: make -C native/circuit   (produces libcircuit_scheduler.so + cli)

#include <algorithm>
#include <cctype>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <exception>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <memory>
#include <queue>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace tfhe_sched {

// Gate opcodes.  Two-input bootstrapped gates match
// zig_tfhe_jax.models.gates.GATE_NAMES order; >= 100 are runtime-special.
enum Op : int32_t {
  NAND = 0, OR = 1, AND = 2, XOR = 3, XNOR = 4, NOR = 5,
  ANDNY = 6, ANDYN = 7, ORNY = 8, ORYN = 9,
  NOT = 100,      // bootstrap-free negation
  COPY = 101,     // bootstrap-free copy
  CONST0 = 102,   // trivial ciphertext
  CONST1 = 103,
  MUX = 104,      // 3-input, 2 blind rotates
  INPUT = 110,
  OUTPUT = 111,
};

struct Gate {
  int32_t op;
  int32_t in0 = -1, in1 = -1, in2 = -1;  // wire ids
  int32_t out = -1;                      // wire id
};

struct Circuit {
  int32_t n_wires = 0;
  std::vector<Gate> gates;
  std::vector<int32_t> inputs;    // wire ids
  std::vector<int32_t> outputs;   // wire ids
  std::string error;
};

// One scheduled gate instance: slots are arena indices, not wire ids.
struct SchedGate {
  int32_t op;
  int32_t s0, s1, s2, sout;
};

struct Plan {
  // level boundaries into `gates`: level L = [level_off[L], level_off[L+1])
  std::vector<int32_t> level_off;
  std::vector<SchedGate> gates;
  std::vector<int32_t> input_slots;   // arena slot of each circuit input
  std::vector<int32_t> output_slots;  // arena slot of each circuit output
  int32_t n_slots = 0;
  std::string error;
};

static bool is_two_input(int32_t op) { return op < 100; }

// ---------------------------------------------------------------------------
// Graph building
// ---------------------------------------------------------------------------

Circuit* circuit_new() { return new Circuit(); }

int32_t circuit_add_wire(Circuit* c) { return c->n_wires++; }

int32_t circuit_add_gate(Circuit* c, int32_t op, int32_t in0, int32_t in1,
                         int32_t in2) {
  Gate g;
  g.op = op;
  g.in0 = in0;
  g.in1 = in1;
  g.in2 = in2;
  g.out = circuit_add_wire(c);
  c->gates.push_back(g);
  return g.out;
}

void circuit_mark_input(Circuit* c, int32_t wire) { c->inputs.push_back(wire); }
void circuit_mark_output(Circuit* c, int32_t wire) { c->outputs.push_back(wire); }

// Whitespace-separated tokens of a NUL-terminated buffer, read with the C
// library rather than iostreams: this library is loaded into processes
// that may carry another C++ runtime, and a string stream touches the
// runtime's locale state (a statically linked runtime in the .so then
// crashes inside the embedding process).
struct Tokens {
  const char* p;

  void skip_space() {
    while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
  }
  bool int64(int64_t& v) {
    skip_space();
    char* end = nullptr;
    long long x = std::strtoll(p, &end, 10);
    if (end == p) return false;
    p = end;
    v = x;
    return true;
  }
  bool int32(int32_t& v) {
    int64_t x = 0;
    if (!int64(x) || x < INT32_MIN || x > INT32_MAX) return false;
    v = static_cast<int32_t>(x);
    return true;
  }
  bool word(std::string& w) {
    skip_space();
    const char* q = p;
    while (*q && !std::isspace(static_cast<unsigned char>(*q))) ++q;
    if (q == p) return false;
    w.assign(p, q);
    p = q;
    return true;
  }
};

// Bristol-fashion parser ("old" Bristol format):
//   line 1: <n_gates> <n_wires>
//   line 2: <n_in1> <n_in2> <n_out>   (wires 0.. are inputs, last are outputs)
//   gates:  <n_in> <n_out> <in...> <out> <OP>
Circuit* circuit_parse_bristol(const char* text) {
  auto* c = new Circuit();
  Tokens in{text};
  int64_t n_gates = 0, n_wires = 0;
  if (!(in.int64(n_gates) && in.int64(n_wires))) {
    c->error = "bad header";
    return c;
  }
  int64_t n_in1 = 0, n_in2 = 0, n_out = 0;
  if (!(in.int64(n_in1) && in.int64(n_in2) && in.int64(n_out))) {
    c->error = "bad io header";
    return c;
  }
  // validate ALL header counts before any loop sized by them: a malformed
  // header like "999999999999 0 1" must become an error string, not a
  // multi-hour push_back loop / OOM in the embedding process
  if (n_gates < 0 || n_wires < 0 || n_gates > (1 << 28) ||
      n_wires > (1 << 28)) {
    c->error = "unreasonable gate/wire counts in header";
    return c;
  }
  if (n_in1 < 0 || n_in2 < 0 || n_out < 0 || n_in1 + n_in2 > n_wires ||
      n_out > n_wires) {
    c->error = "unreasonable io counts in header";
    return c;
  }
  c->n_wires = static_cast<int32_t>(n_wires);
  for (int64_t i = 0; i < n_in1 + n_in2; ++i)
    c->inputs.push_back(static_cast<int32_t>(i));
  for (int64_t i = 0; i < n_out; ++i)
    c->outputs.push_back(static_cast<int32_t>(n_wires - n_out + i));

  static const std::unordered_map<std::string, int32_t> ops = {
      {"AND", AND},   {"NAND", NAND}, {"OR", OR},     {"NOR", NOR},
      {"XOR", XOR},   {"XNOR", XNOR}, {"INV", NOT},   {"NOT", NOT},
      {"ANDNY", ANDNY}, {"ANDYN", ANDYN}, {"ORNY", ORNY}, {"ORYN", ORYN},
      {"COPY", COPY}, {"EQW", COPY},  {"MUX", MUX},
  };
  for (int64_t gi = 0; gi < n_gates; ++gi) {
    int32_t n_gin = 0, n_gout = 0;
    if (!(in.int32(n_gin) && in.int32(n_gout))) {
      c->error = "truncated gate list at gate " + std::to_string(gi);
      return c;
    }
    // validate arities BEFORE sizing vectors: negative/huge counts from a
    // malformed file must become an error string, not a length_error that
    // aborts the embedding process through the C ABI
    if (n_gin < 0 || n_gin > 3 || n_gout != 1) {
      c->error = "bad gate arity at gate " + std::to_string(gi);
      return c;
    }
    std::vector<int32_t> gin(n_gin), gout(n_gout);
    std::string opname;
    bool ok = true;
    for (auto& w : gin) ok = ok && in.int32(w);
    for (auto& w : gout) ok = ok && in.int32(w);
    if (!ok || !in.word(opname)) {
      c->error = "truncated gate at gate " + std::to_string(gi);
      return c;
    }
    auto it = ops.find(opname);
    if (it == ops.end() || n_gout != 1) {
      c->error = "unsupported gate '" + opname + "'";
      return c;
    }
    Gate g;
    g.op = it->second;
    g.out = gout[0];
    if (is_two_input(g.op)) {
      if (n_gin != 2) { c->error = "2-input op arity"; return c; }
      g.in0 = gin[0]; g.in1 = gin[1];
    } else if (g.op == NOT || g.op == COPY) {
      if (n_gin != 1) { c->error = "1-input op arity"; return c; }
      g.in0 = gin[0];
    } else if (g.op == MUX) {
      if (n_gin != 3) { c->error = "mux arity"; return c; }
      g.in0 = gin[0]; g.in1 = gin[1]; g.in2 = gin[2];
    }
    c->gates.push_back(g);
  }
  return c;
}

// ---------------------------------------------------------------------------
// Scheduling: leveling + liveness slot allocation
//
// cap == 0: plain ASAP leveling (every ready gate runs at its earliest
// level) — the round-4 behavior, kept as the regression reference.
//
// cap > 0: capacity-and-slack LIST SCHEDULING (the round-5 ragged-tail
// fix).  ASAP leveling leaves narrow levels (a 7-gate level dispatches a
// 7-lane blind rotation whose wall-clock equals a 2048-lane one — the
// measured ~30% Bristol gap at B=1).  Instead, each emitted level takes
// ready gates in ALAP-slack order (critical-path gates first) up to a
// ROTATION-LANE budget of `cap` (two-input gate = 1 lane, MUX = 2,
// NOT/COPY/CONST = 0 — they are arena ops, always emitted when ready):
// gates with slack defer out of over-wide levels and TOP UP later narrow
// ones, driving the dispatch count toward the critical-path depth while
// no level exceeds the throughput knee.  Depth never grows beyond
// max(ASAP depth, ceil(total_lanes / cap)) and the within-level
// independence invariant (a gate never reads a same-level output) holds
// by construction of the ready set.
// ---------------------------------------------------------------------------

Plan* circuit_schedule(const Circuit* c, int32_t cap) {
  auto* plan = new Plan();
  const int32_t W = c->n_wires;
  const auto& gates = c->gates;

  // Bounds-check EVERY wire id before any vector indexing: gate inputs and
  // circuit input/output marks come from untrusted Bristol text / ctypes
  // callers, and an out-of-range id would be an OOB read/write below.
  for (size_t i = 0; i < gates.size(); ++i) {
    for (int32_t w : {gates[i].in0, gates[i].in1, gates[i].in2}) {
      if (w < -1 || w >= W) {
        plan->error = "gate " + std::to_string(i) + " input wire " +
                      std::to_string(w) + " out of range";
        return plan;
      }
    }
  }
  for (int32_t w : c->inputs) {
    if (w < 0 || w >= W) {
      plan->error = "circuit input wire " + std::to_string(w) +
                    " out of range";
      return plan;
    }
  }
  for (int32_t w : c->outputs) {
    if (w < 0 || w >= W) {
      plan->error = "circuit output wire " + std::to_string(w) +
                    " out of range";
      return plan;
    }
  }

  // producer[w] = gate index writing wire w (-1 for inputs)
  std::vector<int32_t> producer(W, -1);
  for (size_t i = 0; i < gates.size(); ++i) {
    if (gates[i].out < 0 || gates[i].out >= W) {
      plan->error = "gate output wire out of range";
      return plan;
    }
    if (producer[gates[i].out] != -1) {
      plan->error = "wire " + std::to_string(gates[i].out) + " written twice";
      return plan;
    }
    producer[gates[i].out] = static_cast<int32_t>(i);
  }

  // Kahn leveling on gate dependencies.
  std::vector<int32_t> indeg(gates.size(), 0);
  std::vector<std::vector<int32_t>> consumers(gates.size());
  auto add_dep = [&](int32_t wire, int32_t gi) {
    if (wire < 0) return;
    int32_t p = producer[wire];
    if (p >= 0) {
      consumers[p].push_back(gi);
      indeg[gi]++;
    }
  };
  for (size_t i = 0; i < gates.size(); ++i) {
    add_dep(gates[i].in0, static_cast<int32_t>(i));
    add_dep(gates[i].in1, static_cast<int32_t>(i));
    add_dep(gates[i].in2, static_cast<int32_t>(i));
  }

  std::vector<int32_t> level(gates.size(), 0);
  std::queue<int32_t> ready;
  for (size_t i = 0; i < gates.size(); ++i)
    if (indeg[i] == 0) ready.push(static_cast<int32_t>(i));
  size_t done = 0;
  int32_t max_level = -1;
  auto indeg_work = indeg;
  std::vector<int32_t> topo;  // Kahn finish order (a topological order)
  topo.reserve(gates.size());
  while (!ready.empty()) {
    int32_t gi = ready.front();
    ready.pop();
    done++;
    topo.push_back(gi);
    max_level = std::max(max_level, level[gi]);
    for (int32_t cj : consumers[gi]) {
      level[cj] = std::max(level[cj], level[gi] + 1);
      if (--indeg_work[cj] == 0) ready.push(cj);
    }
  }
  if (done != gates.size()) {
    plan->error = "cycle detected in circuit";
    return plan;
  }

  if (cap > 0 && !gates.empty()) {
    // ALAP levels (unit edges): latest level each gate may run without
    // stretching the ASAP depth.  slack = alap - asap >= 0.
    std::vector<int32_t> alap(gates.size(), max_level);
    for (size_t k = topo.size(); k-- > 0;) {
      int32_t gi = topo[k];
      for (int32_t cj : consumers[gi])
        alap[gi] = std::min(alap[gi], alap[cj] - 1);
    }
    auto lane_weight = [&](int32_t gi) -> int32_t {
      int32_t op = gates[gi].op;
      if (is_two_input(op)) return 1;
      if (op == MUX) return 2;  // 2 blind-rotation lanes
      return 0;                 // NOT/COPY/CONST: arena ops, free
    };
    // min-heaps on (alap, gate index) — critical (low-slack) gates first,
    // deterministic tie-break
    auto cmp = [&](int32_t a, int32_t b) {
      return alap[a] != alap[b] ? alap[a] > alap[b] : a > b;
    };
    std::priority_queue<int32_t, std::vector<int32_t>, decltype(cmp)>
        ready_boot(cmp), ready_free(cmp);
    indeg_work = indeg;
    for (size_t i = 0; i < gates.size(); ++i)
      if (indeg[i] == 0)
        (lane_weight(static_cast<int32_t>(i)) ? ready_boot : ready_free)
            .push(static_cast<int32_t>(i));
    std::vector<int32_t> emitted;
    size_t scheduled = 0;
    int32_t round = 0;
    while (scheduled < gates.size()) {
      emitted.clear();
      while (!ready_free.empty()) {        // free ops: all of them, now
        emitted.push_back(ready_free.top());
        ready_free.pop();
      }
      int32_t used = 0;
      while (!ready_boot.empty()) {
        int32_t gi = ready_boot.top();
        int32_t w = lane_weight(gi);
        if (used > 0 && used + w > cap) break;
        ready_boot.pop();
        emitted.push_back(gi);
        used += w;
      }
      if (emitted.empty()) {
        plan->error = "internal: list scheduler stalled";  // unreachable
        return plan;
      }
      for (int32_t gi : emitted) {
        level[gi] = round;
        scheduled++;
      }
      // consumers become ready for LATER rounds only (same-level reads
      // of same-level outputs are impossible by construction)
      for (int32_t gi : emitted)
        for (int32_t cj : consumers[gi])
          if (--indeg_work[cj] == 0)
            (lane_weight(cj) ? ready_boot : ready_free).push(cj);
      round++;
    }
  }

  // Order gates by level (stable).
  std::vector<int32_t> order(gates.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = static_cast<int32_t>(i);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return level[a] < level[b]; });

  // Liveness: last position (in scheduled order) each wire is read; outputs
  // and input wires live forever (inputs may be re-read by the caller).
  std::vector<int32_t> last_use(W, -1);
  for (size_t pos = 0; pos < order.size(); ++pos) {
    const Gate& g = gates[order[pos]];
    for (int32_t w : {g.in0, g.in1, g.in2})
      if (w >= 0) last_use[w] = static_cast<int32_t>(pos);
  }
  std::vector<char> pinned(W, 0);
  for (int32_t w : c->outputs) pinned[w] = 1;
  for (int32_t w : c->inputs) pinned[w] = 1;

  // Slot allocation with a free list.
  std::vector<int32_t> slot_of(W, -1);
  std::vector<int32_t> free_slots;
  int32_t n_slots = 0;
  auto alloc_slot = [&](int32_t wire) {
    if (slot_of[wire] >= 0) return slot_of[wire];
    int32_t s;
    if (!free_slots.empty()) {
      s = free_slots.back();
      free_slots.pop_back();
    } else {
      s = n_slots++;
    }
    slot_of[wire] = s;
    return s;
  };
  for (int32_t w : c->inputs) alloc_slot(w);

  // Emit scheduled gates; free dead wires after their last read, but only
  // at LEVEL boundaries (all gates in a level read the arena concurrently).
  plan->level_off.push_back(0);
  int32_t cur_level = gates.empty() ? 0 : level[order[0]];
  std::vector<int32_t> pending_free;
  auto flush_level = [&]() {
    for (int32_t s : pending_free) free_slots.push_back(s);
    pending_free.clear();
  };
  for (size_t pos = 0; pos < order.size(); ++pos) {
    const Gate& g = gates[order[pos]];
    if (level[order[pos]] != cur_level) {
      flush_level();
      plan->level_off.push_back(static_cast<int32_t>(plan->gates.size()));
      cur_level = level[order[pos]];
    }
    SchedGate sg;
    sg.op = g.op;
    sg.s0 = g.in0 >= 0 ? slot_of[g.in0] : -1;
    sg.s1 = g.in1 >= 0 ? slot_of[g.in1] : -1;
    sg.s2 = g.in2 >= 0 ? slot_of[g.in2] : -1;
    // a used-but-never-produced non-input wire has no slot: make that a
    // schedule error instead of emitting a -1 the evaluator would treat as
    // a wrapped arena index
    for (int32_t w : {g.in0, g.in1, g.in2}) {
      if (w >= 0 && slot_of[w] < 0 && producer[w] < 0) {
        plan->error = "gate reads wire " + std::to_string(w) +
                      " that is neither an input nor produced by any gate";
        return plan;
      }
    }
    // free inputs whose last use is this position (deferred to level end);
    // dedupe within the gate — AND(x, x) must free x's slot ONCE, or two
    // later live wires would share one slot and corrupt each other
    const int32_t ins[3] = {g.in0, g.in1, g.in2};
    for (int k = 0; k < 3; ++k) {
      int32_t w = ins[k];
      if (w < 0 || pinned[w] || last_use[w] != static_cast<int32_t>(pos) ||
          slot_of[w] < 0)
        continue;
      bool dup = false;
      for (int j = 0; j < k; ++j) dup = dup || (ins[j] == w);
      if (!dup) pending_free.push_back(slot_of[w]);
    }
    sg.sout = alloc_slot(g.out);
    plan->gates.push_back(sg);
  }
  plan->level_off.push_back(static_cast<int32_t>(plan->gates.size()));
  plan->n_slots = n_slots;
  for (int32_t w : c->inputs) plan->input_slots.push_back(slot_of[w]);
  for (int32_t w : c->outputs) {
    if (slot_of[w] < 0) {
      plan->error = "output wire " + std::to_string(w) +
                    " is never written by any gate or input";
      return plan;
    }
    plan->output_slots.push_back(slot_of[w]);
  }
  return plan;
}

}  // namespace tfhe_sched

// ---------------------------------------------------------------------------
// C ABI (ctypes)
// ---------------------------------------------------------------------------

using tfhe_sched::Circuit;
using tfhe_sched::Plan;

extern "C" {

Circuit* tfhe_circuit_new() { return tfhe_sched::circuit_new(); }
void tfhe_circuit_free(Circuit* c) { delete c; }
int32_t tfhe_circuit_add_wire(Circuit* c) { return tfhe_sched::circuit_add_wire(c); }
int32_t tfhe_circuit_add_gate(Circuit* c, int32_t op, int32_t a, int32_t b,
                              int32_t s) {
  return tfhe_sched::circuit_add_gate(c, op, a, b, s);
}
void tfhe_circuit_mark_input(Circuit* c, int32_t w) {
  tfhe_sched::circuit_mark_input(c, w);
}
void tfhe_circuit_mark_output(Circuit* c, int32_t w) {
  tfhe_sched::circuit_mark_output(c, w);
}
// Exceptions must not cross the C ABI (ctypes) — a bad_alloc escaping
// extern "C" calls std::terminate and kills the embedding process.
Circuit* tfhe_circuit_parse_bristol(const char* text) {
  try {
    return tfhe_sched::circuit_parse_bristol(text);
  } catch (const std::exception& e) {
    auto* c = new Circuit();
    c->error = std::string("parse exception: ") + e.what();
    return c;
  }
}
const char* tfhe_circuit_error(Circuit* c) { return c->error.c_str(); }
int32_t tfhe_circuit_n_gates(Circuit* c) {
  return static_cast<int32_t>(c->gates.size());
}
int32_t tfhe_circuit_n_inputs(Circuit* c) {
  return static_cast<int32_t>(c->inputs.size());
}
int32_t tfhe_circuit_n_outputs(Circuit* c) {
  return static_cast<int32_t>(c->outputs.size());
}

Plan* tfhe_schedule_capped(Circuit* c, int32_t cap) {
  try {
    return tfhe_sched::circuit_schedule(c, cap);
  } catch (const std::exception& e) {
    auto* p = new Plan();
    p->error = std::string("schedule exception: ") + e.what();
    return p;
  }
}

// Back-compat: plain ASAP leveling (cap = 0).
Plan* tfhe_schedule(Circuit* c) { return tfhe_schedule_capped(c, 0); }
void tfhe_plan_free(Plan* p) { delete p; }
const char* tfhe_plan_error(Plan* p) { return p->error.c_str(); }
int32_t tfhe_plan_n_levels(Plan* p) {
  return static_cast<int32_t>(p->level_off.size()) - 1;
}
int32_t tfhe_plan_n_gates(Plan* p) {
  return static_cast<int32_t>(p->gates.size());
}
int32_t tfhe_plan_n_slots(Plan* p) { return p->n_slots; }
int32_t tfhe_plan_n_inputs(Plan* p) {
  return static_cast<int32_t>(p->input_slots.size());
}
int32_t tfhe_plan_n_outputs(Plan* p) {
  return static_cast<int32_t>(p->output_slots.size());
}
const int32_t* tfhe_plan_level_offsets(Plan* p) { return p->level_off.data(); }
// gates as a flat [n_gates, 5] int32 array: op, s0, s1, s2, sout
void tfhe_plan_gates(Plan* p, int32_t* out) {
  for (size_t i = 0; i < p->gates.size(); ++i) {
    out[i * 5 + 0] = p->gates[i].op;
    out[i * 5 + 1] = p->gates[i].s0;
    out[i * 5 + 2] = p->gates[i].s1;
    out[i * 5 + 3] = p->gates[i].s2;
    out[i * 5 + 4] = p->gates[i].sout;
  }
}
void tfhe_plan_input_slots(Plan* p, int32_t* out) {
  std::memcpy(out, p->input_slots.data(),
              p->input_slots.size() * sizeof(int32_t));
}
void tfhe_plan_output_slots(Plan* p, int32_t* out) {
  std::memcpy(out, p->output_slots.data(),
              p->output_slots.size() * sizeof(int32_t));
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CLI: schedule a Bristol circuit file and print level statistics.
// ---------------------------------------------------------------------------
#ifdef TFHE_SCHED_MAIN
int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s circuit.bristol\n", argv[0]);
    return 2;
  }
  std::ifstream f(argv[1]);
  std::stringstream ss;
  ss << f.rdbuf();
  std::string text = ss.str();
  Circuit* c = tfhe_circuit_parse_bristol(text.c_str());
  if (!c->error.empty()) {
    std::fprintf(stderr, "parse error: %s\n", c->error.c_str());
    return 1;
  }
  Plan* p = tfhe_schedule(c);
  if (!p->error.empty()) {
    std::fprintf(stderr, "schedule error: %s\n", p->error.c_str());
    return 1;
  }
  std::printf("gates=%d levels=%d slots=%d inputs=%d outputs=%d\n",
              tfhe_plan_n_gates(p), tfhe_plan_n_levels(p),
              tfhe_plan_n_slots(p), tfhe_circuit_n_inputs(c),
              tfhe_circuit_n_outputs(c));
  for (int32_t l = 0; l < tfhe_plan_n_levels(p); ++l) {
    int32_t width = p->level_off[l + 1] - p->level_off[l];
    std::printf("level %3d: %6d gates\n", l, width);
  }
  tfhe_plan_free(p);
  tfhe_circuit_free(c);
  return 0;
}
#endif
