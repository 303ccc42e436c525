from repro_torch.kernels.scan.ops import (  # noqa: F401
    ScanTrace,
    mma_scan,
    mma_scan_plain,
    mma_scan_torch,
    scan_geometry,
)
