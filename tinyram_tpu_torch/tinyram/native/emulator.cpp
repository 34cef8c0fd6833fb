// TinyRAM 2.0 native emulator — fast trace generation for long programs.
// The port's copy of tinyram_tpu/tinyram/native/emulator.cpp.
//
// Semantics mirror reference/src/trace.rs:378-552 exactly (same flag
// rules, pc rules, tape-to-memory convention); the Python emulator
// (emulator.py) is the readable reference, this is the production path for
// 2^20+-step traces (SURVEY.md §3.1: hot loop = the instruction match).
//
// C ABI only — loaded via ctypes.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Instr {
  uint8_t op;
  uint8_t ri;
  uint8_t rj;
  uint8_t a_is_imm;
  uint64_t a;
};

enum Op : uint8_t {
  AND = 0b00000, OR = 0b00001, XOR = 0b00010, NOT = 0b00011,
  ADD = 0b00100, SUB = 0b00101, MULL = 0b00110, UMULH = 0b00111,
  SMULH = 0b01000, UDIV = 0b01001, UMOD = 0b01010, SHL = 0b01011,
  SHR = 0b01100, CMPE = 0b01101, CMPA = 0b01110, CMPAE = 0b01111,
  CMPG = 0b10000, CMPGE = 0b10001, MOV = 0b10010, CMOV = 0b10011,
  JMP = 0b10100, CJMP = 0b10101, CNJMP = 0b10110, STOREW = 0b11100,
  LOADW = 0b11101, ANSWER = 0b11111,
};

inline int64_t decode_signed(uint64_t w, int wb) {
  uint64_t m = 1ull << (wb - 1);
  return (int64_t)(w & (m - 1)) - (int64_t)(w & m);
}

}  // namespace

extern "C" {

// Access record: kind 0=init 1=store 2=load
struct AccessOut {
  uint64_t address;
  uint64_t time;
  uint64_t value;
  uint8_t kind;
};

// Returns number of executed steps, or -1 on error (no Answer within
// max_steps / pc out of range).  Output arrays must be sized:
//   pc,opcode,v_addr,inst_index: max_steps; flag: max_steps+1;
//   regs: (max_steps+1)*reg_count; accesses: tape_len + 2*max_steps.
long tinyram_run(const Instr* prog, long prog_len, const uint64_t* tape,
                 long tape_len, int word_bits, int reg_count, long max_steps,
                 int64_t* out_pc, int64_t* out_opcode, int64_t* out_vaddr,
                 int64_t* out_inst_index, int64_t* out_regs, int64_t* out_flag,
                 AccessOut* out_acc, long* out_acc_count, int64_t* out_answer) {
  const uint64_t mask = (word_bits >= 64) ? ~0ull : ((1ull << word_bits) - 1);
  std::vector<uint64_t> regs(reg_count, 0);
  std::unordered_map<uint64_t, uint64_t> mem;
  long acc_n = 0;
  for (long i = 0; i < tape_len; i++) {
    uint64_t addr = (uint64_t)i * word_bits / 8;
    mem[addr] = tape[i] & mask;
    out_acc[acc_n++] = {addr, 0, tape[i] & mask, 0};
  }
  uint64_t pc = 0;
  bool flag = false;
  long t = 0;
  out_flag[0] = 0;
  for (int r = 0; r < reg_count; r++) out_regs[r] = 0;
  bool answered = false;

  while (t < max_steps) {
    if (pc >= (uint64_t)prog_len) return -1;
    const Instr& in = prog[pc];
    uint64_t a = (in.a_is_imm ? in.a : regs[in.a]) & mask;
    uint64_t time = (uint64_t)t + 1;

    uint64_t v_addr = 0;
    if (in.op == LOADW) {
      auto it = mem.find(a);
      if (it == mem.end()) {
        mem[a] = 0;
        out_acc[acc_n++] = {a, 0, 0, 0};
        it = mem.find(a);
      }
      v_addr = it->second;
      out_acc[acc_n++] = {a, time, v_addr, 2};
    } else if (in.op == STOREW) {
      uint64_t val = regs[in.ri];
      if (!mem.count(a)) {
        mem[a] = 0;
        out_acc[acc_n++] = {a, 0, 0, 0};
      }
      mem[a] = val;
      out_acc[acc_n++] = {a, time, val, 1};
      v_addr = val;
    }

    out_pc[t] = (int64_t)pc;
    out_opcode[t] = in.op;
    out_vaddr[t] = (int64_t)v_addr;
    out_inst_index[t] = (int64_t)pc;

    uint64_t x, r;
    switch (in.op) {
      case AND: r = (regs[in.rj] & a); regs[in.ri] = r; flag = r == 0; break;
      case OR: r = (regs[in.rj] | a); regs[in.ri] = r; flag = r == 0; break;
      case XOR: r = (regs[in.rj] ^ a); regs[in.ri] = r; flag = r == 0; break;
      case NOT: r = (~a) & mask; regs[in.ri] = r; flag = r == 0; break;
      case ADD:
        r = regs[in.rj] + a;
        regs[in.ri] = r & mask;
        flag = r > mask;
        break;
      case SUB:
        r = regs[in.rj] + (mask + 1) - a;
        regs[in.ri] = r & mask;
        flag = (r >> word_bits) == 0;
        break;
      // The products below are exact for word_bits <= 32, the most that
      // eval_program_native accepts: both operands are below 2^W, so the
      // unsigned product is below 2^(2W) <= 2^64; the signed operands lie
      // in [-2^(W-1), 2^(W-1)), so |f| <= 2^(2W-2) <= 2^62 fits an int64,
      // and >> of a negative f shifts arithmetically (C++20; g++ always).
      case MULL:
        r = regs[in.rj] * a;
        regs[in.ri] = r & mask;
        flag = r <= mask;
        break;
      case UMULH:
        r = (regs[in.rj] * a) >> word_bits;
        regs[in.ri] = r & mask;
        flag = regs[in.ri] == 0;
        break;
      case SMULH: {
        int64_t f = decode_signed(a, word_bits) *
                    decode_signed(regs[in.rj], word_bits);
        regs[in.ri] = (uint64_t)(f >> word_bits) & mask;
        flag = regs[in.ri] == 0;
        break;
      }
      case UDIV:
        regs[in.ri] = a == 0 ? 0 : regs[in.rj] / a;
        flag = a == 0;
        break;
      case UMOD:
        regs[in.ri] = a == 0 ? 0 : regs[in.rj] % a;
        flag = a == 0;
        break;
      case SHL:
        x = regs[in.rj];
        regs[in.ri] = (a < 64) ? (x << a) & mask : 0;
        flag = (x >> (word_bits - 1)) & 1;
        break;
      case SHR:
        x = regs[in.rj];
        regs[in.ri] = (a < 64) ? (x >> a) : 0;
        flag = x & 1;
        break;
      case CMPE: flag = regs[in.ri] == a; break;
      case CMPA: flag = regs[in.ri] > a; break;
      case CMPAE: flag = regs[in.ri] >= a; break;
      case CMPG:
        flag = decode_signed(regs[in.ri], word_bits) >
               decode_signed(a, word_bits);
        break;
      case CMPGE:
        flag = decode_signed(regs[in.ri], word_bits) >=
               decode_signed(a, word_bits);
        break;
      case MOV: regs[in.ri] = a; break;
      case CMOV:
        if (flag) regs[in.ri] = a;
        break;
      case LOADW: regs[in.ri] = v_addr; break;
      case STOREW: break;
      case ANSWER: *out_answer = (int64_t)a; answered = true; break;
      case JMP: case CJMP: case CNJMP: break;
      default: return -1;
    }

    if (in.op == JMP) pc = a;
    else if (in.op == CJMP) pc = flag ? a : pc + 1;
    else if (in.op == CNJMP) pc = flag ? pc + 1 : a;
    else pc += 1;

    t += 1;
    for (int rr = 0; rr < reg_count; rr++)
      out_regs[t * reg_count + rr] = (int64_t)regs[rr];
    out_flag[t] = flag ? 1 : 0;
    if (answered) break;
  }
  if (!answered) return -1;
  *out_acc_count = acc_n;
  return t;
}

}  // extern "C"
