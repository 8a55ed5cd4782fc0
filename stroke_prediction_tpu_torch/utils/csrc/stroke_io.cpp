// stroke_io — the port's native NIfTI-1 codec (a copy of the JAX package's
// native/stroke_io.cpp, kept in the port so that the port needs nothing of
// that package).
#include <cmath>
//
// zlib-inflated .nii.gz decode straight into caller-owned float32 buffers
// (no intermediate Python objects), and deflated encode for the testers'
// NIfTI dumps.  Exposed as a plain C ABI consumed via ctypes
// (stroke_prediction_tpu_torch/utils/native_io.py), which builds it at
// first use with g++ -O3 -fPIC -shared -std=c++17 ... -lz.
//
// Layout notes: NIfTI stores voxels Fortran-order (x fastest).  The decode
// keeps that order; the Python layer's (X,Y,Z)->(D,H,W) transpose is a
// numpy view.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr int kHeaderSize = 348;

#pragma pack(push, 1)
struct Nifti1Header {
  int32_t sizeof_hdr;
  char data_type[10];
  char db_name[18];
  int32_t extents;
  int16_t session_error;
  char regular;
  char dim_info;
  int16_t dim[8];
  float intent_p1, intent_p2, intent_p3;
  int16_t intent_code;
  int16_t datatype;
  int16_t bitpix;
  int16_t slice_start;
  float pixdim[8];
  float vox_offset;
  float scl_slope;
  float scl_inter;
  int16_t slice_end;
  char slice_code;
  char xyzt_units;
  float cal_max, cal_min;
  float slice_duration;
  float toffset;
  int32_t glmax, glmin;
  char descrip[80];
  char aux_file[24];
  int16_t qform_code;
  int16_t sform_code;
  float quatern_b, quatern_c, quatern_d;
  float qoffset_x, qoffset_y, qoffset_z;
  float srow_x[4];
  float srow_y[4];
  float srow_z[4];
  char intent_name[16];
  char magic[4];
};
#pragma pack(pop)

static_assert(sizeof(Nifti1Header) == kHeaderSize, "NIfTI-1 header layout");

// Read a whole file, inflating if it is gzip (magic 1f 8b).
bool ReadMaybeGz(const char* path, std::vector<uint8_t>* out) {
  gzFile f = gzopen(path, "rb");  // gzread passes plain files through
  if (!f) return false;
  gzbuffer(f, 1 << 20);
  out->clear();
  out->reserve(1 << 22);
  uint8_t buf[1 << 20];
  int n;
  while ((n = gzread(f, buf, sizeof(buf))) > 0) {
    out->insert(out->end(), buf, buf + n);
  }
  bool ok = (n == 0);
  gzclose(f);
  return ok;
}

template <typename T>
void ConvertToFloat(const uint8_t* src, int64_t count, float slope,
                    float inter, float* dst) {
  const T* s = reinterpret_cast<const T*>(src);
  if (slope == 0.0f) slope = 1.0f;
  if (slope == 1.0f && inter == 0.0f) {
    for (int64_t i = 0; i < count; ++i) dst[i] = static_cast<float>(s[i]);
  } else {
    for (int64_t i = 0; i < count; ++i)
      dst[i] = static_cast<float>(s[i]) * slope + inter;
  }
}

}  // namespace

extern "C" {

// Parse header only: fills dims[8] (NIfTI dim array), affine[12] (3 srow
// rows), and the total voxel count. Returns 0 on success.
int sp_nifti_header(const char* path, int64_t dims[8], float affine[12],
                    int64_t* voxels) {
  std::vector<uint8_t> raw;
  if (!ReadMaybeGz(path, &raw) || raw.size() < kHeaderSize) return 1;
  const Nifti1Header* h = reinterpret_cast<const Nifti1Header*>(raw.data());
  if (h->sizeof_hdr != kHeaderSize) return 2;  // (big-endian unsupported)
  int ndim = h->dim[0];
  if (ndim < 1 || ndim > 7) return 3;
  int64_t count = 1;
  for (int i = 0; i < 8; ++i) dims[i] = h->dim[i];
  for (int i = 1; i <= ndim; ++i) count *= h->dim[i];
  *voxels = count;
  if (h->sform_code > 0) {
    memcpy(affine + 0, h->srow_x, 4 * sizeof(float));
    memcpy(affine + 4, h->srow_y, 4 * sizeof(float));
    memcpy(affine + 8, h->srow_z, 4 * sizeof(float));
  } else {
    memset(affine, 0, 12 * sizeof(float));
    affine[0] = affine[5] = affine[10] = 1.0f;
  }
  return 0;
}

// Decode the voxel data as float32 into caller-allocated `out` (voxels
// elements, Fortran order as stored). Returns 0 on success.
int sp_nifti_read_f32(const char* path, float* out, int64_t voxels) {
  std::vector<uint8_t> raw;
  if (!ReadMaybeGz(path, &raw) || raw.size() < kHeaderSize) return 1;
  const Nifti1Header* h = reinterpret_cast<const Nifti1Header*>(raw.data());
  if (h->sizeof_hdr != kHeaderSize) return 2;
  int64_t offset = static_cast<int64_t>(h->vox_offset);
  if (offset < kHeaderSize) offset = kHeaderSize + 4;
  int64_t need = voxels;
  const uint8_t* src = raw.data() + offset;
  int64_t avail_bytes = static_cast<int64_t>(raw.size()) - offset;
  float slope = h->scl_slope, inter = h->scl_inter;
  switch (h->datatype) {
    case 2:   // uint8
      if (avail_bytes < need) return 4;
      ConvertToFloat<uint8_t>(src, need, slope, inter, out);
      break;
    case 4:   // int16
      if (avail_bytes < need * 2) return 4;
      ConvertToFloat<int16_t>(src, need, slope, inter, out);
      break;
    case 8:   // int32
      if (avail_bytes < need * 4) return 4;
      ConvertToFloat<int32_t>(src, need, slope, inter, out);
      break;
    case 16:  // float32
      if (avail_bytes < need * 4) return 4;
      ConvertToFloat<float>(src, need, slope, inter, out);
      break;
    case 64:  // float64
      if (avail_bytes < need * 8) return 4;
      ConvertToFloat<double>(src, need, slope, inter, out);
      break;
    case 256:  // int8
      if (avail_bytes < need) return 4;
      ConvertToFloat<int8_t>(src, need, slope, inter, out);
      break;
    case 512:  // uint16
      if (avail_bytes < need * 2) return 4;
      ConvertToFloat<uint16_t>(src, need, slope, inter, out);
      break;
    default:
      return 5;
  }
  return 0;
}

// Write a float32 volume as NIfTI-1 (.nii.gz when gzip_level > 0, plain
// .nii otherwise). dims: up to 7 entries; affine: 12 floats (3 srow rows).
int sp_nifti_write_f32(const char* path, const float* data,
                       const int64_t* dims, int ndim, const float* affine,
                       int gzip_level) {
  if (ndim < 1 || ndim > 7) return 3;
  Nifti1Header h;
  memset(&h, 0, sizeof(h));
  h.sizeof_hdr = kHeaderSize;
  h.dim[0] = static_cast<int16_t>(ndim);
  int64_t count = 1;
  for (int i = 0; i < 7; ++i) {
    int64_t d = (i < ndim) ? dims[i] : 1;
    h.dim[i + 1] = static_cast<int16_t>(d);
    if (i < ndim) count *= d;
  }
  h.datatype = 16;  // float32
  h.bitpix = 32;
  h.pixdim[0] = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float* row = affine + 4 * i;
    float norm = std::sqrt(row[0] * row[0] + row[1] * row[1]
                           + row[2] * row[2]);
    h.pixdim[i + 1] = (norm > 0) ? norm : 1.0f;
  }
  for (int i = 4; i < 8; ++i) h.pixdim[i] = 1.0f;
  h.vox_offset = 352.0f;
  h.scl_slope = 1.0f;
  h.qform_code = 1;
  h.sform_code = 1;
  h.qoffset_x = affine[3];
  h.qoffset_y = affine[7];
  h.qoffset_z = affine[11];
  memcpy(h.srow_x, affine + 0, 4 * sizeof(float));
  memcpy(h.srow_y, affine + 4, 4 * sizeof(float));
  memcpy(h.srow_z, affine + 8, 4 * sizeof(float));
  memcpy(h.magic, "n+1", 4);

  const char ext[4] = {0, 0, 0, 0};
  if (gzip_level > 0) {
    std::string mode = "wb" + std::to_string(gzip_level);
    gzFile f = gzopen(path, mode.c_str());
    if (!f) return 1;
    gzbuffer(f, 1 << 20);
    bool ok = gzwrite(f, &h, kHeaderSize) == kHeaderSize
        && gzwrite(f, ext, 4) == 4
        && gzwrite(f, data, count * 4) == static_cast<int>(count * 4);
    gzclose(f);
    return ok ? 0 : 2;
  }
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  bool ok = fwrite(&h, 1, kHeaderSize, f) == kHeaderSize
      && fwrite(ext, 1, 4, f) == 4
      && fwrite(data, 4, count, f) == static_cast<size_t>(count);
  fclose(f);
  return ok ? 0 : 2;
}

}  // extern "C"
