// The C++ engine's stages timed in process: parse vs encode vs pack, with
// no ring and no threads, by #including the port's engine source
// (shark_tpu_torch/native/shark_native.cpp). The port's counterpart of
// bench/native_stage_bench.cpp.
//
//   g++ -O3 -march=native -std=c++17 -pthread -o build/shark_tpu_torch/native_stage_bench \
//       scripts/native_stage_bench_torch.cpp -lz
//   build/shark_tpu_torch/native_stage_bench FASTQ [B=65536] [L=104] [FASTQ2|-] [MINQ=0]
//
// Three passes over the sample; each prints one JSON line:
//   {"pass": p, "reads": n, "parse_s": .., "encode_s": .., "pack_s": ..}
// parse: FastxReader into a Batch (parse_batch); encode: the byte codes
// with the quality mask (encode_batch_rows with the pack off); pack: the
// planar 2-bit pack of those codes (pack_row). The engine itself fuses
// encode and pack through one row buffer and runs them on its encoder
// thread while the next batch parses.
#include "../shark_tpu_torch/native/shark_native.cpp"

#include <chrono>

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s FASTQ [B] [L] [FASTQ2|-] [MINQ]\n", argv[0]);
    return 2;
  }
  const char* path = argv[1];
  int B = argc > 2 ? atoi(argv[2]) : 65536;
  int L = argc > 3 ? atoi(argv[3]) : 104;
  const char* path2 = argc > 4 && strcmp(argv[4], "-") != 0 ? argv[4] : "";
  int minq = argc > 5 ? atoi(argv[5]) : 0;
  if (B <= 0 || L <= 0 || L % 8 != 0) {
    fprintf(stderr, "B must be > 0 and L a positive multiple of 8\n");
    return 2;
  }
  using clk = std::chrono::steady_clock;
  auto secs = [](clk::time_point a, clk::time_point b) {
    return std::chrono::duration<double>(b - a).count();
  };

  for (int pass = 0; pass < 3; pass++) {
    Stream s;
    s.batch_size = B;
    s.max_len = L;
    s.min_quality = minq;
    s.f1 = new FastxReader(path);
    if (!s.f1->ok()) {
      fprintf(stderr, "cannot open %s\n", path);
      return 1;
    }
    if (*path2) {
      s.f2 = new FastxReader(path2);
      s.paired = true;
      if (!s.f2->ok()) {
        fprintf(stderr, "cannot open %s\n", path2);
        return 1;
      }
    }
    Batch b;
    double t_parse = 0, t_enc = 0, t_pack = 0;
    long n_total = 0;
    while (true) {
      auto t0 = clk::now();
      int n = parse_batch(&s, b);
      auto t1 = clk::now();
      t_parse += secs(t0, t1);
      if (n < 0) {
        fprintf(stderr, "parse error: %s\n", s.err.c_str());
        return 1;
      }
      if (n == 0) break;
      n_total += n;
      s.pack_mode = false;
      std::string err;
      if (encode_batch_rows(&s, b, err) < 0) {
        fprintf(stderr, "encode error: %s\n", err.c_str());
        return 1;
      }
      auto t2 = clk::now();
      t_enc += secs(t1, t2);
      b.packed.resize((size_t)B * (L / 4));
      b.vmask.resize((size_t)B * (L / 8));
      for (int i = 0; i < b.n; i++)
        pack_row(b.codes.data() + (size_t)i * L, L,
                 b.packed.data() + (size_t)i * (L / 4),
                 b.vmask.data() + (size_t)i * (L / 8));
      t_pack += secs(t2, clk::now());
    }
    delete s.f1;
    s.f1 = nullptr;
    delete s.f2;
    s.f2 = nullptr;
    printf("{\"pass\": %d, \"reads\": %ld, \"parse_s\": %.6f, "
           "\"encode_s\": %.6f, \"pack_s\": %.6f}\n",
           pass, n_total, t_parse, t_enc, t_pack);
  }
  return 0;
}
