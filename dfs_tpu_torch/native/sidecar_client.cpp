// sidecar_client — a client of the dfs.Sidecar gRPC service written
// with POSIX sockets only: no gRPC library, no HTTP/2 library, no
// protobuf. A copy of dfs_tpu's client of the same name, built by
// dfs_tpu_torch/native/__init__.py (build_sidecar_client); it speaks the
// wire contract of docs/sidecar_wire.md to the port's sidecar
// (dfs_tpu_torch/sidecar/service.py, served over the port's own HTTP/2
// stack in dfs_tpu_torch/sidecar/h2.py) or to dfs_tpu's.
// tests/test_torch_sidecar.py and chip_smoke.py's cluster_sidecar phase
// run it against a live sidecar and check its chunk tables byte for byte.
//
//   usage: sidecar_client <host> <port> <file> [method]
//
// Streams <file> into /dfs.Sidecar/ChunkHashStream as gRPC
// length-prefixed messages over an HTTP/2 cleartext (h2c,
// prior-knowledge) connection and prints the JSON chunk table the
// service returns to stdout. Exit 0 on a complete response stream.
//
// HTTP/2 subset implemented (RFC 9113): connection preface, SETTINGS
// exchange + ack, HEADERS with a static-table-only HPACK encoding (no
// dynamic table, no Huffman — always legal for a sender), DATA with
// both flow-control windows respected, WINDOW_UPDATE both directions,
// PING ack, padded/priority flag handling on receive. Response header
// blocks are not HPACK-decoded — the conformance signal is the chunk
// table itself.

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

[[noreturn]] void die(const std::string& m) {
  std::fprintf(stderr, "sidecar_client: %s\n", m.c_str());
  std::exit(2);
}

void write_all(int fd, const char* p, size_t n) {
  while (n) {
    ssize_t w = ::send(fd, p, n, 0);
    if (w <= 0) die("send failed");
    p += w;
    n -= static_cast<size_t>(w);
  }
}

void read_exact(int fd, char* p, size_t n) {
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) die("recv failed (connection closed or timed out)");
    p += r;
    n -= static_cast<size_t>(r);
  }
}

std::string frame(uint8_t type, uint8_t flags, uint32_t stream,
                  const std::string& payload) {
  std::string f;
  uint32_t len = static_cast<uint32_t>(payload.size());
  f.push_back(static_cast<char>((len >> 16) & 0xFF));
  f.push_back(static_cast<char>((len >> 8) & 0xFF));
  f.push_back(static_cast<char>(len & 0xFF));
  f.push_back(static_cast<char>(type));
  f.push_back(static_cast<char>(flags));
  f.push_back(static_cast<char>((stream >> 24) & 0x7F));
  f.push_back(static_cast<char>((stream >> 16) & 0xFF));
  f.push_back(static_cast<char>((stream >> 8) & 0xFF));
  f.push_back(static_cast<char>(stream & 0xFF));
  f += payload;
  return f;
}

constexpr uint8_t kData = 0x0, kHeaders = 0x1, kRstStream = 0x3,
                  kSettings = 0x4, kPing = 0x6, kGoaway = 0x7,
                  kWindowUpdate = 0x8;
constexpr uint8_t kEndStream = 0x1, kAck = 0x1, kEndHeaders = 0x4,
                  kPadded = 0x8, kPriority = 0x20;

struct Conn {
  int fd = -1;
  int64_t conn_window = 65535;    // our send budget, connection-level
  int64_t stream_window = 65535;  // our send budget, stream 1
  int32_t peer_initial_window = 65535;
  uint32_t max_frame = 16384;
  std::string response;  // stream-1 DATA bytes (the gRPC response)
  bool done = false;     // END_STREAM seen on stream 1

  // Read and handle exactly one frame from the server.
  void pump() {
    char h[9];
    read_exact(fd, h, 9);
    uint32_t len = (static_cast<uint8_t>(h[0]) << 16) |
                   (static_cast<uint8_t>(h[1]) << 8) |
                   static_cast<uint8_t>(h[2]);
    uint8_t type = static_cast<uint8_t>(h[3]);
    uint8_t flags = static_cast<uint8_t>(h[4]);
    uint32_t stream = ((static_cast<uint8_t>(h[5]) & 0x7F) << 24) |
                      (static_cast<uint8_t>(h[6]) << 16) |
                      (static_cast<uint8_t>(h[7]) << 8) |
                      static_cast<uint8_t>(h[8]);
    std::vector<char> buf(len);
    if (len) read_exact(fd, buf.data(), len);

    switch (type) {
      case kSettings: {
        if (flags & kAck) break;
        for (uint32_t off = 0; off + 6 <= len; off += 6) {
          uint16_t id = (static_cast<uint8_t>(buf[off]) << 8) |
                        static_cast<uint8_t>(buf[off + 1]);
          uint32_t val = (static_cast<uint8_t>(buf[off + 2]) << 24) |
                         (static_cast<uint8_t>(buf[off + 3]) << 16) |
                         (static_cast<uint8_t>(buf[off + 4]) << 8) |
                         static_cast<uint8_t>(buf[off + 5]);
          if (id == 0x4) {  // INITIAL_WINDOW_SIZE: retro-adjusts streams
            stream_window += static_cast<int64_t>(val) - peer_initial_window;
            peer_initial_window = static_cast<int32_t>(val);
          } else if (id == 0x5) {  // MAX_FRAME_SIZE
            max_frame = val;
          }
        }
        std::string ack = frame(kSettings, kAck, 0, "");
        write_all(fd, ack.data(), ack.size());
        break;
      }
      case kWindowUpdate: {
        if (len != 4) die("bad WINDOW_UPDATE");
        uint32_t inc = ((static_cast<uint8_t>(buf[0]) & 0x7F) << 24) |
                       (static_cast<uint8_t>(buf[1]) << 16) |
                       (static_cast<uint8_t>(buf[2]) << 8) |
                       static_cast<uint8_t>(buf[3]);
        (stream == 0 ? conn_window : stream_window) += inc;
        break;
      }
      case kPing: {
        if (!(flags & kAck)) {
          std::string pong =
              frame(kPing, kAck, 0, std::string(buf.data(), len));
          write_all(fd, pong.data(), pong.size());
        }
        break;
      }
      case kData: {
        if (stream != 1) break;
        size_t begin = 0, end = len;
        if (flags & kPadded) {
          if (len == 0) die("padded DATA frame with no pad length");
          uint8_t pad = static_cast<uint8_t>(buf[0]);
          if (static_cast<size_t>(pad) + 1 > len)
            die("DATA pad length exceeds frame");
          begin = 1;
          end = len - pad;
        }
        response.append(buf.data() + begin, end - begin);
        if (len) {  // hand the server its receive window back
          std::string inc;
          for (char c : {0, 0, 0, 0}) inc.push_back(c);
          inc[0] = static_cast<char>((len >> 24) & 0x7F);
          inc[1] = static_cast<char>((len >> 16) & 0xFF);
          inc[2] = static_cast<char>((len >> 8) & 0xFF);
          inc[3] = static_cast<char>(len & 0xFF);
          std::string w0 = frame(kWindowUpdate, 0, 0, inc);
          std::string w1 = frame(kWindowUpdate, 0, 1, inc);
          write_all(fd, w0.data(), w0.size());
          write_all(fd, w1.data(), w1.size());
        }
        if (flags & kEndStream) done = true;
        break;
      }
      case kHeaders: {  // response headers / trailers; block not decoded
        if (stream == 1 && (flags & kEndStream)) done = true;
        break;
      }
      case kRstStream:
        die("server reset the stream");
      case kGoaway: {
        if (!done) die("server GOAWAY before response completed");
        break;
      }
      default:
        break;  // PUSH_PROMISE/CONTINUATION/unknown: ignore
    }
  }

  void send_flow_controlled(const char* p, size_t n, bool end_stream) {
    while (n) {
      size_t take = n;
      if (take > max_frame) take = max_frame;
      while (conn_window < static_cast<int64_t>(take) ||
             stream_window < static_cast<int64_t>(take)) {
        pump();  // wait for WINDOW_UPDATE / process SETTINGS / PING
      }
      bool last = (take == n) && end_stream;
      std::string f = frame(kData, last ? kEndStream : 0, 1,
                            std::string(p, take));
      write_all(fd, f.data(), f.size());
      conn_window -= static_cast<int64_t>(take);
      stream_window -= static_cast<int64_t>(take);
      p += take;
      n -= take;
    }
  }
};

// Incremental gRPC message parser over Conn::response: returns complete
// length-prefixed payloads as they accumulate, advancing *consumed.
bool next_message(const std::string& resp, size_t* consumed,
                  std::string* out) {
  if (resp.size() < *consumed + 5) return false;
  const uint8_t* p =
      reinterpret_cast<const uint8_t*>(resp.data()) + *consumed;
  if (p[0] != 0) die("compressed response unsupported");
  uint32_t mlen = (static_cast<uint32_t>(p[1]) << 24) |
                  (static_cast<uint32_t>(p[2]) << 16) |
                  (static_cast<uint32_t>(p[3]) << 8) | p[4];
  if (resp.size() < *consumed + 5 + mlen) return false;
  out->assign(resp, *consumed + 5, mlen);
  *consumed += 5 + static_cast<size_t>(mlen);
  return true;
}

// Minimal scanner for `"key": <non-negative integer>` in the sidecar's
// JSON replies (stdlib json.dumps layout; whitespace after ':' optional).
// Returns the LAST value of the key, or -1 if absent.
int64_t last_int_field(const std::string& js, const std::string& key) {
  const std::string needle = "\"" + key + "\":";
  int64_t found = -1;
  size_t at = 0;
  while ((at = js.find(needle, at)) != std::string::npos) {
    size_t q = at + needle.size();
    while (q < js.size() && (js[q] == ' ' || js[q] == '\t')) ++q;
    int64_t v = 0;
    bool any = false;
    while (q < js.size() && js[q] >= '0' && js[q] <= '9') {
      v = v * 10 + (js[q] - '0');
      ++q;
      any = true;
    }
    if (any) found = v;
    at = q;
  }
  return found;
}

// gRPC length-prefix for the next message: [flag=0][4-byte BE length].
// Single definition — every method's sender goes through it.
void send_grpc_prefix(Conn& c, uint64_t n) {
  if (n > 0xFFFFFFFFULL) die("gRPC message too large (4 GiB-1 cap)");
  char hdr[5] = {'\0', static_cast<char>((n >> 24) & 0xFF),
                 static_cast<char>((n >> 16) & 0xFF),
                 static_cast<char>((n >> 8) & 0xFF),
                 static_cast<char>(n & 0xFF)};
  c.send_flow_controlled(hdr, 5, false);
}

// HPACK, encoder side only: static-table indexed fields plus
// literal-without-indexing — never requires a dynamic table or Huffman.
std::string hpack_request_headers(const std::string& authority,
                                  const std::string& path) {
  std::string hb;
  hb.push_back('\x83');  // :method: POST   (static table index 3)
  hb.push_back('\x86');  // :scheme: http   (static table index 6)
  auto literal = [&hb](int name_index, const std::string& value) {
    // literal field without indexing, 4-bit prefixed name index
    if (name_index < 15) {
      hb.push_back(static_cast<char>(name_index));
    } else {
      hb.push_back('\x0F');
      hb.push_back(static_cast<char>(name_index - 15));
    }
    if (value.size() > 126) die("header value too long for this encoder");
    hb.push_back(static_cast<char>(value.size()));  // Huffman bit clear
    hb += value;
  };
  literal(4, path);                    // :path
  literal(1, authority);               // :authority
  literal(31, "application/grpc");     // content-type
  // te: trailers — name not in the static table: literal new name
  hb.push_back('\x00');
  hb.push_back('\x02');
  hb += "te";
  hb.push_back('\x08');
  hb += "trailers";
  return hb;
}

// Open a connection and start stream 1 for the given method:
// preface + SETTINGS + HEADERS, ready for request DATA frames.
Conn dial(const std::string& host, const std::string& port,
          const std::string& method) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0 || !res)
    die("getaddrinfo failed");
  Conn c;
  c.fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (c.fd < 0 || ::connect(c.fd, res->ai_addr, res->ai_addrlen) != 0)
    die("connect failed");
  freeaddrinfo(res);
  timeval tv{60, 0};
  setsockopt(c.fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));

  static const char kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
  write_all(c.fd, kPreface, sizeof(kPreface) - 1);
  std::string s = frame(kSettings, 0, 0, "");
  write_all(c.fd, s.data(), s.size());

  std::string hb = hpack_request_headers(
      host + ":" + port, "/dfs.Sidecar/" + method);
  std::string hf = frame(kHeaders, kEndHeaders, 1, hb);
  write_all(c.fd, hf.data(), hf.size());
  return c;
}

// Unary Health on its own connection: the duplex tee sizes its buffer
// cap from the advertised reporting-lag window, exactly like the
// in-process teeing client (dfs_tpu_torch/sidecar/service.py
// SidecarFragmenter).
int64_t fetch_window(const std::string& host, const std::string& port) {
  Conn c = dial(host, port, "Health");
  send_grpc_prefix(c, 0);  // one empty gRPC message
  std::string fin = frame(kData, kEndStream, 1, "");
  write_all(c.fd, fin.data(), fin.size());
  while (!c.done) c.pump();
  size_t consumed = 0;
  std::string msg;
  if (!next_message(c.response, &consumed, &msg))
    die("no Health response message");
  ::close(c.fd);
  int64_t w = last_int_field(msg, "window");
  if (w < 0) die("Health reply lacks a window field");
  return w;
}

// ChunkHashDuplex with the teeing discipline a storage node uses: at
// most 2*window un-reported bytes in flight (window = Health's
// reporting-lag bound; 0 = materializing backend -> uncapped), reads
// interleaved with writes so chunk batches stream back DURING the
// upload. A sidecar whose real lag exceeded its advertised window
// would deadlock this client — the 60 s socket timeout turns that
// into a loud failure, which is the conformance point.
int run_duplex(const std::string& host, const std::string& port,
               FILE* f) {
  int64_t window = fetch_window(host, port);
  const int64_t cap = window > 0 ? 2 * window : -1;

  Conn c = dial(host, port, "ChunkHashDuplex");
  std::vector<char> block(64 * 1024);
  size_t consumed = 0;
  int64_t sent = 0, reported = 0;  // bytes sent / last reported chunk end
  bool got_done = false;
  std::string msg;

  auto drain = [&]() {
    while (next_message(c.response, &consumed, &msg)) {
      std::fwrite(msg.data(), 1, msg.size(), stdout);
      std::fputc('\n', stdout);
      int64_t off = last_int_field(msg, "offset");
      int64_t len = last_int_field(msg, "length");
      if (off >= 0 && len >= 0 && off + len > reported)
        reported = off + len;
      if (last_int_field(msg, "size") >= 0 &&
          msg.find("\"done\"") != std::string::npos)
        got_done = true;
    }
    // Trim the consumed prefix: `consumed` only ever advances, so the
    // reply buffer would otherwise hold every streamed chunk report for
    // the whole run — unbounded growth on multi-GiB conformance
    // streams. Amortized: erase (an O(remaining) move) only once the
    // dead prefix passes 1 MiB, never per message.
    if (consumed > (1u << 20)) {
      c.response.erase(0, consumed);
      consumed = 0;
    }
  };

  bool eof = false;
  while (!eof && !c.done) {   // c.done mid-upload = server ended early;
    // fall through to the !got_done check instead of writing into (or
    // cap-blocking on) a dead stream until the socket timeout fires
    if (cap > 0 && sent - reported >= cap) {
      // tee buffer full: block until the sidecar reports chunks
      c.pump();
      drain();
      continue;
    }
    size_t n = std::fread(block.data(), 1, block.size(), f);
    if (n == 0) {
      eof = true;
      break;
    }
    send_grpc_prefix(c, n);
    c.send_flow_controlled(block.data(), n, false);
    sent += static_cast<int64_t>(n);
    drain();  // send_flow_controlled may have pumped response frames
  }
  if (!c.done) {  // half-close only a live stream: after an early
    // server END_STREAM (+ closed TCP) the send would SIGPIPE and
    // mask the loud no-done-message diagnostic below
    std::string fin = frame(kData, kEndStream, 1, "");
    write_all(c.fd, fin.data(), fin.size());
  }
  while (!c.done) {
    c.pump();
    drain();
  }
  drain();
  ::close(c.fd);
  if (!got_done) die("duplex stream ended without a done message");
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 4 && argc != 5) {
    std::fprintf(stderr,
                 "usage: %s <host> <port> <file> [method]\n"
                 "  method: ChunkHashStream (default), ChunkHash, "
                 "ChunkHashDuplex, Health\n",
                 argv[0]);
    return 2;
  }
  const std::string host = argv[1], port = argv[2], path = argv[3];
  const std::string method = argc == 5 ? argv[4] : "ChunkHashStream";
  if (method != "ChunkHashStream" && method != "ChunkHash" &&
      method != "ChunkHashDuplex" && method != "Health")
    die("unknown method " + method +
        " (want ChunkHashStream, ChunkHash, ChunkHashDuplex, or Health)");

  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) die("cannot open " + path);

  if (method == "ChunkHashDuplex") {
    int rc = run_duplex(host, port, f);
    std::fclose(f);
    return rc;
  }

  Conn c = dial(host, port, method);

  // the request as gRPC length-prefixed messages:
  // [1-byte compressed flag = 0][4-byte big-endian length][payload].
  // ChunkHashStream: one message per file block. ChunkHash: the whole
  // file in ONE message. Health: one empty message (the file argument
  // is ignored beyond being openable).
  std::vector<char> block(64 * 1024);
  if (method == "Health") {
    send_grpc_prefix(c, 0);
  } else if (method == "ChunkHash") {
    // one message for the whole file: the prefix comes from the file
    // size and the payload streams through — the gRPC message framing
    // has no alignment to DATA frames, so no whole-file buffer needed
    if (std::fseek(f, 0, SEEK_END) != 0) die("seek failed");
    long sz = std::ftell(f);
    if (sz < 0) die("ftell failed");
    std::rewind(f);
    send_grpc_prefix(c, static_cast<uint64_t>(sz));
    uint64_t sent = 0;
    for (;;) {
      size_t n = std::fread(block.data(), 1, block.size(), f);
      if (n == 0) break;
      c.send_flow_controlled(block.data(), n, false);
      sent += n;
    }
    if (sent != static_cast<uint64_t>(sz))
      die("file changed size mid-read");
  } else {  // ChunkHashStream (validated in main's prologue)
    for (;;) {
      size_t n = std::fread(block.data(), 1, block.size(), f);
      if (n == 0) break;
      send_grpc_prefix(c, n);
      c.send_flow_controlled(block.data(), n, false);
    }
  }
  std::fclose(f);
  std::string fin = frame(kData, kEndStream, 1, "");  // half-close
  write_all(c.fd, fin.data(), fin.size());

  while (!c.done) c.pump();

  size_t consumed = 0;
  std::string msg;
  if (!next_message(c.response, &consumed, &msg))
    die("no (or truncated) gRPC response message");
  std::fwrite(msg.data(), 1, msg.size(), stdout);
  std::fputc('\n', stdout);
  ::close(c.fd);
  return 0;
}
