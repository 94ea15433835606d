// streamsink: native HTTP MJPEG server for live viewing of engine frames.
//
// The reference presents frames in a native OS window (winit/Vulkan
// swapchain, reference: src/boilerplate.rs + src/debugui.rs).  On a
// headless accelerator host there is no display, so the analog is a push
// stream: an embedded HTTP server that serves multipart/x-mixed-replace JPEG
// (the de-facto "MJPEG over HTTP" protocol every browser understands).
// Point a browser at http://host:port/ and the simulation is live.
//
// Architecture (all off the simulation thread, mirroring framesink.cpp):
//   * submit() copies the RGB frame into a latest-wins slot (never blocks on
//     slow clients; the sim thread pays one memcpy).
//   * one encoder thread JPEG-compresses the newest slot (libjpeg, custom
//     in-memory destination) and bumps a sequence number.
//   * one accept thread + one thread per client; each client thread waits on
//     the sequence number and writes boundary + JPEG part.  Slow clients
//     skip frames (they always get the newest encoded frame, never a queue).
//
// Interaction: the page captures keydown/keyup and fires GET /key?d=1&k=a
// back at the server; events land in a bounded queue the simulation thread
// drains via ss_poll_keys each frame (the reference's winit keyboard events,
// src/keyboard.rs:3-45, routed over HTTP for a headless host).
//
// C API (ctypes-friendly):
//   void* ss_create(const char* bind_addr, int port, int width, int height,
//                   int quality);   // bind_addr e.g. "127.0.0.1"/"0.0.0.0"
//   int   ss_port(void* h);           // actual bound port (for port=0)
//   int   ss_submit(void* h, const unsigned char* rgb);  // w*h*3 bytes
//   long  ss_clients(void* h);
//   long  ss_frames(void* h);         // frames encoded so far
//   void  ss_set_key_token(void* h, const char* token);
//         // when set, /key requests need t=<token> (see key_token below)
//   int   ss_poll_keys(void* h, char* buf, int buflen);
//         // drains queued key events into buf as newline-separated
//         // "<down> <key>" records ("1 a\n0 ArrowLeft\n"); returns bytes
//         // written (excluding the NUL terminator)
//   void  ss_close(void* h);
//
// Build: g++ -O2 -shared -fPIC -o libstreamsink.so streamsink.cpp -ljpeg -lpthread

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <utility>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// ---- in-memory libjpeg destination (portable: jpeg_mem_dest is not part
// of the 62 ABI everywhere) ----
struct VecDest {
  jpeg_destination_mgr mgr;
  std::vector<uint8_t>* out;
  uint8_t buf[16384];
};

void dest_init(j_compress_ptr c) {
  VecDest* d = reinterpret_cast<VecDest*>(c->dest);
  d->mgr.next_output_byte = d->buf;
  d->mgr.free_in_buffer = sizeof(d->buf);
}

boolean dest_empty(j_compress_ptr c) {
  VecDest* d = reinterpret_cast<VecDest*>(c->dest);
  d->out->insert(d->out->end(), d->buf, d->buf + sizeof(d->buf));
  d->mgr.next_output_byte = d->buf;
  d->mgr.free_in_buffer = sizeof(d->buf);
  return TRUE;
}

void dest_term(j_compress_ptr c) {
  VecDest* d = reinterpret_cast<VecDest*>(c->dest);
  d->out->insert(d->out->end(), d->buf,
                 d->buf + (sizeof(d->buf) - d->mgr.free_in_buffer));
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr c) {
  JpegErr* e = reinterpret_cast<JpegErr*>(c->err);
  longjmp(e->jump, 1);
}

bool encode_jpeg(const uint8_t* rgb, int w, int h, int quality,
                 std::vector<uint8_t>& out) {
  out.clear();
  jpeg_compress_struct c;
  JpegErr err;
  c.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&c);
    return false;
  }
  jpeg_create_compress(&c);
  VecDest dest;
  dest.out = &out;
  dest.mgr.init_destination = dest_init;
  dest.mgr.empty_output_buffer = dest_empty;
  dest.mgr.term_destination = dest_term;
  c.dest = &dest.mgr;
  c.image_width = w;
  c.image_height = h;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, quality, TRUE);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb + c.next_scanline * w * 3);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  return true;
}

constexpr const char* kBoundary = "spacetimeframe";

const char* kIndexHtml =
    "<!doctype html><html><head><title>spacetime_tpu live</title>"
    "<style>body{margin:0;background:#111;display:flex;align-items:center;"
    "justify-content:center;height:100vh}img{max-width:100%;max-height:100%}"
    "</style></head><body><img src=\"/stream\">"
    // keyboard events back to the engine: a/d/w/s + arrows pan, z/x zoom,
    // p pause, +/- max-FPS, o boosted view, [/]{/} 3D spin (viewer.apply_key)
    // a key token (non-loopback binds) rides the page URL: /?t=TOKEN is
    // echoed back on every /key fetch
    "<script>const tk=new URLSearchParams(location.search).get('t');"
    "const s=(d,e)=>{if(e.key&&!e.metaKey&&!e.ctrlKey)"
    "fetch('/key?d='+d+'&k='+encodeURIComponent(e.key)"
    "+(tk?'&t='+encodeURIComponent(tk):''))};"
    "window.addEventListener('keydown',e=>{if(!e.repeat)s(1,e)});"
    "window.addEventListener('keyup',e=>s(0,e));</script>"
    "</body></html>";

// %XX-decode (the JS encodeURIComponent counterpart); invalid escapes pass
// through literally
std::string url_decode(const std::string& in) {
  std::string out;
  out.reserve(in.size());
  for (size_t i = 0; i < in.size(); ++i) {
    if (in[i] == '%' && i + 2 < in.size() && isxdigit(in[i + 1]) &&
        isxdigit(in[i + 2])) {
      out.push_back(static_cast<char>(
          std::stoi(in.substr(i + 1, 2), nullptr, 16)));
      i += 2;
    } else {
      out.push_back(in[i] == '+' ? ' ' : in[i]);
    }
  }
  return out;
}

struct StreamSink {
  int width, height, quality;
  int listen_fd = -1;
  int port = 0;

  std::mutex raw_mu;
  std::condition_variable raw_cv;
  std::vector<uint8_t> raw_slot;  // latest submitted frame (latest wins)
  bool raw_fresh = false;

  std::mutex enc_mu;
  std::condition_variable enc_cv;
  std::vector<uint8_t> jpeg;  // latest encoded frame
  uint64_t seq = 0;

  std::atomic<long> n_clients{0};
  std::atomic<long> n_frames{0};
  std::atomic<bool> closing{false};

  // key events from browser clients, drained by the sim thread each frame;
  // bounded so a hostile client can't grow memory (oldest events win: a
  // stuck queue means the sim thread stopped polling, so drop new input)
  std::mutex keys_mu;
  std::vector<std::string> key_events;  // each "<down> <key>"
  static constexpr size_t kMaxKeyQueue = 256;
  // when non-empty, /key requests must carry a matching t=<token> or the
  // event is dropped: /key steers (and can terminate) the engine, so a
  // non-loopback bind without a shared secret would hand control to any
  // network peer that can reach the stream port (ADVICE r4)
  std::string key_token;

  std::thread encoder;
  std::thread acceptor;
  // each entry pairs the thread with a done flag the thread sets on exit, so
  // the acceptor can reap finished threads (join is instant once done) —
  // without the sweep a long --serve session with reconnecting browsers
  // grows this vector without bound
  std::vector<std::pair<std::thread, std::shared_ptr<std::atomic<bool>>>>
      clients;
  std::mutex clients_mu;

  void encode_loop() {
    std::vector<uint8_t> local;
    std::vector<uint8_t> out;
    while (true) {
      {
        std::unique_lock<std::mutex> lk(raw_mu);
        raw_cv.wait(lk, [&] { return raw_fresh || closing.load(); });
        if (closing.load()) return;
        local.swap(raw_slot);
        raw_slot.resize(local.size());
        raw_fresh = false;
      }
      if (!encode_jpeg(local.data(), width, height, quality, out)) continue;
      {
        std::lock_guard<std::mutex> lk(enc_mu);
        jpeg = out;
        ++seq;
      }
      n_frames.fetch_add(1);
      enc_cv.notify_all();
    }
  }

  static bool send_all(int fd, const void* data, size_t len) {
    const char* p = static_cast<const char*>(data);
    while (len > 0) {
      ssize_t k = ::send(fd, p, len, MSG_NOSIGNAL);
      if (k <= 0) return false;
      p += k;
      len -= static_cast<size_t>(k);
    }
    return true;
  }

  void client_loop(int fd) {
    n_clients.fetch_add(1);
    // minimal request parse: first line up to CRLF, ignore headers
    std::string req;
    char ch;
    while (req.size() < 4096 && req.find("\r\n\r\n") == std::string::npos) {
      ssize_t k = ::recv(fd, &ch, 1, 0);
      if (k <= 0) break;
      req.push_back(ch);
    }
    bool stream = req.compare(0, 11, "GET /stream") == 0;
    bool key = req.compare(0, 9, "GET /key?") == 0;
    if (key) {
      // query string: d=<0|1>&k=<urlencoded key name>, order-insensitive
      size_t eol = req.find(' ', 9);  // end of request-target
      std::string qs = req.substr(9, eol == std::string::npos ? std::string::npos
                                                              : eol - 9);
      std::string down, name, tok;
      size_t pos = 0;
      while (pos < qs.size()) {
        size_t amp = qs.find('&', pos);
        std::string kv = qs.substr(pos, amp == std::string::npos
                                            ? std::string::npos
                                            : amp - pos);
        if (kv.compare(0, 2, "d=") == 0) down = kv.substr(2);
        if (kv.compare(0, 2, "k=") == 0) name = url_decode(kv.substr(2));
        if (kv.compare(0, 2, "t=") == 0) tok = url_decode(kv.substr(2));
        if (amp == std::string::npos) break;
        pos = amp + 1;
      }
      if (!key_token.empty() && tok != key_token) {
        const char* resp =
            "HTTP/1.1 403 Forbidden\r\nConnection: close\r\n\r\n";
        send_all(fd, resp, std::strlen(resp));
        ::close(fd);
        n_clients.fetch_sub(1);
        return;
      }
      if (!name.empty() && name.size() <= 32 &&
          name.find('\n') == std::string::npos) {
        std::lock_guard<std::mutex> lk(keys_mu);
        if (key_events.size() < kMaxKeyQueue)
          key_events.push_back((down == "0" ? "0 " : "1 ") + name);
      }
      const char* resp =
          "HTTP/1.1 204 No Content\r\nConnection: close\r\n\r\n";
      send_all(fd, resp, std::strlen(resp));
    } else if (!stream) {
      std::string body = kIndexHtml;
      char hdr[256];
      std::snprintf(hdr, sizeof(hdr),
                    "HTTP/1.1 200 OK\r\nContent-Type: text/html\r\n"
                    "Content-Length: %zu\r\nConnection: close\r\n\r\n",
                    body.size());
      send_all(fd, hdr, std::strlen(hdr));
      send_all(fd, body.data(), body.size());
    } else {
      const char* hdr =
          "HTTP/1.1 200 OK\r\n"
          "Content-Type: multipart/x-mixed-replace; boundary=spacetimeframe\r\n"
          "Cache-Control: no-cache\r\nConnection: close\r\n\r\n";
      if (!send_all(fd, hdr, std::strlen(hdr))) goto done;
      {
        uint64_t last = 0;
        std::vector<uint8_t> frame;
        while (!closing.load()) {
          {
            std::unique_lock<std::mutex> lk(enc_mu);
            enc_cv.wait(lk, [&] { return seq != last || closing.load(); });
            if (closing.load()) break;
            frame = jpeg;
            last = seq;
          }
          char part[128];
          std::snprintf(part, sizeof(part),
                        "--%s\r\nContent-Type: image/jpeg\r\n"
                        "Content-Length: %zu\r\n\r\n",
                        kBoundary, frame.size());
          if (!send_all(fd, part, std::strlen(part))) break;
          if (!send_all(fd, frame.data(), frame.size())) break;
          if (!send_all(fd, "\r\n", 2)) break;
        }
      }
    }
  done:
    ::close(fd);
    n_clients.fetch_sub(1);
  }

  void accept_loop() {
    while (!closing.load()) {
      sockaddr_in peer{};
      socklen_t len = sizeof(peer);
      int fd = ::accept(listen_fd, reinterpret_cast<sockaddr*>(&peer), &len);
      if (fd < 0) {
        if (closing.load()) return;
        continue;
      }
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> lk(clients_mu);
      // reap finished client threads before adding a new one
      for (auto it = clients.begin(); it != clients.end();) {
        if (it->second->load()) {
          if (it->first.joinable()) it->first.join();
          it = clients.erase(it);
        } else {
          ++it;
        }
      }
      auto done = std::make_shared<std::atomic<bool>>(false);
      clients.emplace_back(std::thread([this, fd, done] {
                             client_loop(fd);
                             done->store(true);
                           }),
                           done);
    }
  }

  bool start(const char* bind_addr, int want_port) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    // loopback by default (the Python wrapper passes "127.0.0.1" unless the
    // user opts into external binding): the stream has no auth
    if (bind_addr == nullptr || bind_addr[0] == '\0' ||
        inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1)
      addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
      return false;
    if (::listen(listen_fd, 8) != 0) return false;
    socklen_t len = sizeof(addr);
    getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    raw_slot.resize(static_cast<size_t>(width) * height * 3);
    encoder = std::thread([this] { encode_loop(); });
    acceptor = std::thread([this] { accept_loop(); });
    return true;
  }

  void stop() {
    closing.store(true);
    raw_cv.notify_all();
    enc_cv.notify_all();
    if (listen_fd >= 0) ::shutdown(listen_fd, SHUT_RDWR);
    if (listen_fd >= 0) ::close(listen_fd);
    if (encoder.joinable()) encoder.join();
    if (acceptor.joinable()) acceptor.join();
    std::lock_guard<std::mutex> lk(clients_mu);
    for (auto& t : clients)
      if (t.first.joinable()) t.first.join();
  }
};

}  // namespace

extern "C" {

void* ss_create(const char* bind_addr, int port, int width, int height,
                int quality) {
  auto* s = new StreamSink();
  s->width = width;
  s->height = height;
  s->quality = quality > 0 && quality <= 100 ? quality : 85;
  if (!s->start(bind_addr, port)) {
    delete s;
    return nullptr;
  }
  return s;
}

int ss_port(void* h) { return static_cast<StreamSink*>(h)->port; }

// install a shared key-input token (call once, before serving clients —
// written without keys_mu, so concurrent mutation would race client threads)
void ss_set_key_token(void* h, const char* token) {
  static_cast<StreamSink*>(h)->key_token = token ? token : "";
}

int ss_submit(void* h, const unsigned char* rgb) {
  auto* s = static_cast<StreamSink*>(h);
  {
    std::lock_guard<std::mutex> lk(s->raw_mu);
    std::memcpy(s->raw_slot.data(), rgb, s->raw_slot.size());
    s->raw_fresh = true;
  }
  s->raw_cv.notify_one();
  return 0;
}

long ss_clients(void* h) { return static_cast<StreamSink*>(h)->n_clients.load(); }

long ss_frames(void* h) { return static_cast<StreamSink*>(h)->n_frames.load(); }

int ss_poll_keys(void* h, char* buf, int buflen) {
  auto* s = static_cast<StreamSink*>(h);
  if (buf == nullptr || buflen <= 0) return 0;
  std::vector<std::string> events;
  {
    std::lock_guard<std::mutex> lk(s->keys_mu);
    events.swap(s->key_events);
  }
  int n = 0;
  for (const auto& e : events) {
    // drop events that don't fit (bound: kMaxKeyQueue * 35 bytes; callers
    // pass 16 KB so this never triggers in practice)
    if (n + static_cast<int>(e.size()) + 1 >= buflen) break;
    std::memcpy(buf + n, e.data(), e.size());
    n += static_cast<int>(e.size());
    buf[n++] = '\n';
  }
  buf[n] = '\0';
  return n;
}

void ss_close(void* h) {
  auto* s = static_cast<StreamSink*>(h);
  s->stop();
  delete s;
}

}  // extern "C"
