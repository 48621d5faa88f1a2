// Native IO runtime of the surfel mapper: PNG frame decoding and map files.
//
// The reference's C++ runtime does synchronous OpenCV imread + GL uploads on
// the critical path (gui/KittiReader.cpp:86-134, src/SurfelMapping.cpp:122-128).
// Here the native layer's job is to keep the card fed: a multithreaded
// libpng frame prefetcher decodes (rgb u8, depth u16-mm, semantic u8) triples
// ahead of the consumer, and map checkpoints stream through plain fread/fwrite
// in the reference's binary format ([u32 count][i32 start][i32 end]
// [count x 12 f32], src/GlobalModel.cpp:901-1011).
//
// C ABI only, consumed from Python via ctypes.  surfelmapping_tpu_torch/io/
// native.py builds it with g++ at first use (-O2 -fPIC -shared ... -lpng -lz
// -lpthread) into build/surfelmapping_tpu_torch/.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
    std::vector<uint8_t> data;  // raw bytes (u8 or u16 little-endian)
    int w = 0, h = 0, channels = 0, bitdepth = 0;
    bool ok = false;
};

bool read_png(const char* path, Image& out) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return false;
    png_byte header[8];
    if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
        std::fclose(fp);
        return false;
    }
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (!png || !info || setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        std::fclose(fp);
        return false;
    }
    png_init_io(png, fp);
    png_set_sig_bytes(png, 8);

    int transforms = PNG_TRANSFORM_PACKING | PNG_TRANSFORM_EXPAND |
                     PNG_TRANSFORM_STRIP_ALPHA;
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    transforms |= PNG_TRANSFORM_SWAP_ENDIAN;  // PNG stores 16-bit big-endian
#endif
    png_read_png(png, info, transforms, nullptr);

    out.w = png_get_image_width(png, info);
    out.h = png_get_image_height(png, info);
    out.bitdepth = png_get_bit_depth(png, info);
    out.channels = png_get_channels(png, info);
    const size_t rowbytes = png_get_rowbytes(png, info);
    png_bytepp rows = png_get_rows(png, info);
    out.data.resize(rowbytes * out.h);
    for (int y = 0; y < out.h; ++y)
        std::memcpy(out.data.data() + y * rowbytes, rows[y], rowbytes);
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    out.ok = true;
    return true;
}

struct Frame {
    Image rgb, depth, sem;
};

struct Loader {
    std::string rgb_dir, depth_dir, sem_dir;
    int first_id, last_id, queue_depth;
    std::atomic<int> next_id;
    std::map<int, Frame*> ready;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    std::vector<std::thread> workers;
    std::atomic<bool> stop{false};
    int consumed;  // all ids < consumed have been taken

    Loader(const char* rd, const char* dd, const char* sd, int f, int l, int nt, int qd)
        : rgb_dir(rd), depth_dir(dd), sem_dir(sd), first_id(f), last_id(l),
          queue_depth(qd), next_id(f), consumed(f) {
        for (int i = 0; i < nt; ++i)
            workers.emplace_back([this] { this->work(); });
    }

    ~Loader() {
        stop = true;
        cv_space.notify_all();
        cv_ready.notify_all();
        for (auto& t : workers) t.join();
        for (auto& kv : ready) delete kv.second;
    }

    static std::string name_for(const std::string& dir, int id) {
        char buf[32];
        std::snprintf(buf, sizeof(buf), "/%06d.png", id);
        return dir + buf;
    }

    void work() {
        while (!stop) {
            int id = next_id.fetch_add(1);
            if (id > last_id) return;
            // bound the readahead window
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_space.wait(lk, [&] {
                    return stop || id < consumed + queue_depth;
                });
                if (stop) return;
            }
            Frame* f = new Frame;
            read_png(name_for(rgb_dir, id).c_str(), f->rgb);
            read_png(name_for(depth_dir, id).c_str(), f->depth);
            read_png(name_for(sem_dir, id).c_str(), f->sem);
            {
                std::lock_guard<std::mutex> lk(mu);
                ready[id] = f;
            }
            cv_ready.notify_all();
        }
    }

    Frame* get(int id) {
        std::unique_lock<std::mutex> lk(mu);
        cv_ready.wait(lk, [&] { return stop || ready.count(id); });
        if (stop) return nullptr;
        Frame* f = ready[id];
        ready.erase(id);
        if (id >= consumed) consumed = id + 1;
        cv_space.notify_all();
        return f;
    }
};

}  // namespace

extern "C" {

int sm_read_png(const char* path, unsigned char** data, int* w, int* h,
                int* channels, int* bitdepth) {
    Image img;
    if (!read_png(path, img)) return -1;
    *data = static_cast<unsigned char*>(std::malloc(img.data.size()));
    std::memcpy(*data, img.data.data(), img.data.size());
    *w = img.w;
    *h = img.h;
    *channels = img.channels;
    *bitdepth = img.bitdepth;
    return 0;
}

void sm_free(void* p) { std::free(p); }

void* sm_loader_create(const char* rgb_dir, const char* depth_dir,
                       const char* sem_dir, int first_id, int last_id,
                       int n_threads, int queue_depth) {
    return new Loader(rgb_dir, depth_dir, sem_dir, first_id, last_id,
                      n_threads, queue_depth);
}

// Returns 0 on success; caller must call sm_frame_free(handle) when done with
// the returned pointers.
int sm_loader_get(void* loader, int frame_id, void** frame_handle,
                  unsigned char** rgb, int* rw, int* rh, int* rc,
                  unsigned char** depth, int* dw, int* dh, int* dbits,
                  unsigned char** sem, int* sw, int* sh) {
    Frame* f = static_cast<Loader*>(loader)->get(frame_id);
    if (!f) return -1;
    if (!f->rgb.ok || !f->depth.ok || !f->sem.ok) {
        delete f;
        return -2;
    }
    *frame_handle = f;
    *rgb = f->rgb.data.data();
    *rw = f->rgb.w; *rh = f->rgb.h; *rc = f->rgb.channels;
    *depth = f->depth.data.data();
    *dw = f->depth.w; *dh = f->depth.h; *dbits = f->depth.bitdepth;
    *sem = f->sem.data.data();
    *sw = f->sem.w; *sh = f->sem.h;
    return 0;
}

void sm_frame_free(void* frame_handle) {
    delete static_cast<Frame*>(frame_handle);
}

void sm_loader_destroy(void* loader) { delete static_cast<Loader*>(loader); }

// --- map checkpoint IO (reference binary format) -------------------------

int sm_save_map(const char* path, const float* rec, unsigned count,
                int start_id, int end_id) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    int ok = std::fwrite(&count, 4, 1, f) == 1 &&
             std::fwrite(&start_id, 4, 1, f) == 1 &&
             std::fwrite(&end_id, 4, 1, f) == 1 &&
             (count == 0 ||
              std::fwrite(rec, sizeof(float) * 12, count, f) == count);
    std::fclose(f);
    return ok ? 0 : -2;
}

// Returns 0 on success; *rec is malloc'd (count*12 floats), caller sm_free's.
int sm_load_map(const char* path, float** rec, unsigned* count, int* start_id,
                int* end_id) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fread(count, 4, 1, f) != 1 || std::fread(start_id, 4, 1, f) != 1 ||
        std::fread(end_id, 4, 1, f) != 1) {
        std::fclose(f);
        return -2;
    }
    const size_t bytes = static_cast<size_t>(*count) * 12 * sizeof(float);
    *rec = static_cast<float*>(std::malloc(bytes));
    if (*count && std::fread(*rec, 1, bytes, f) != bytes) {
        std::free(*rec);
        std::fclose(f);
        return -3;
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
