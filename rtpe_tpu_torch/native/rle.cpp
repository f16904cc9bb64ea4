// COCO RLE codec — native replacement for pycocotools' C extension
// (the reference depends on it for crowd masks; SURVEY.md §2.4).
// Counts use the COCO ascii varint scheme (5 bits/char offset 48, sign
// extension on 0x10, delta-coded from the 3rd count).

#include <cstdint>
#include <cstring>

extern "C" {

// Decode the ascii counts string into int64 counts.
// Returns the number of counts, or -1 if max_counts exceeded.
int rle_decode_counts(const char* s, int slen, long long* counts,
                      int max_counts) {
    int n = 0;
    int i = 0;
    while (i < slen) {
        long long x = 0;
        int k = 0;
        bool more = true;
        while (more && i < slen) {
            int c = s[i] - 48;
            x |= (long long)(c & 0x1F) << (5 * k);
            more = (c & 0x20) != 0;
            ++i;
            ++k;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (n > 2) x += counts[n - 2];
        if (n >= max_counts) return -1;
        counts[n++] = x;
    }
    return n;
}

// Expand counts into a column-major flat binary mask of `size` bytes.
int rle_decode_mask(const long long* counts, int n, unsigned char* mask,
                    long long size) {
    std::memset(mask, 0, (size_t)size);
    long long pos = 0;
    int val = 0;
    for (int i = 0; i < n; ++i) {
        long long c = counts[i];
        if (pos + c > size) c = size - pos;
        if (val) std::memset(mask + pos, 1, (size_t)c);
        pos += c;
        val ^= 1;
        if (pos >= size) break;
    }
    return 0;
}

// Run-length encode a column-major flat binary mask. Returns the number
// of counts (first run is of zeros), or -1 on overflow.
int rle_encode_mask(const unsigned char* flat, long long size,
                    long long* counts, int max_counts) {
    int n = 0;
    unsigned char cur = 0;
    long long run = 0;
    for (long long i = 0; i < size; ++i) {
        unsigned char v = flat[i] ? 1 : 0;
        if (v == cur) {
            ++run;
        } else {
            if (n >= max_counts) return -1;
            counts[n++] = run;
            cur = v;
            run = 1;
        }
    }
    if (n >= max_counts) return -1;
    counts[n++] = run;
    return n;
}

}  // extern "C"
