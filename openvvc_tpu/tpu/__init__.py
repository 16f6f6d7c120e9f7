"""Device-resident frame reconstruction pipeline.

The host C parser (native/parse.c) and IR builder (native/recon.c
ov_build_ir) turn each picture into dense tensors — residual planes,
per-4x4-unit motion grids, wave-scheduled intra job records, filter maps.
One fused jitted program per frame (frame_program.py) then runs inter MC,
intra wavefront reconstruction, deblocking and SAO entirely on device with
the DPB resident in device memory (device_dpb.py), transferring one output
frame back per picture. This replaces the reference's per-CU interleaved
parse+reconstruct dispatch (/root/reference/libovvc/rcn.c:147-300,
slicedec.c:712-760) with the split-parse / batched-reconstruct design of
SURVEY.md §7.1.
"""
