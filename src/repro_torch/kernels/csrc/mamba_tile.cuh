// The layout of the tile states that the mamba scan's forward
// (mamba_scan.cu) keeps under training and its backward (mamba_scan_bwd.cu)
// starts its tiles from: [B, ceil(S / kStateTile), D, N] float, the state
// before every kStateTile-step tile, entry 0 being h0.  Both kernels take
// the spacing from here, and each library exports it as
// mamba_state_tile(), which cuda_lib.py holds against its
// MAMBA_STATE_TILE (the states' shape on the Python side) when it loads
// the library.
#pragma once

namespace mamba {

constexpr int kStateTile = 16;  // steps between kept states

}  // namespace mamba

extern "C" int mamba_state_tile() { return mamba::kStateTile; }
