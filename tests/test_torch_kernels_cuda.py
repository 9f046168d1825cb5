"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Skipped where PyTorch sees no GPU (decided in the fixture). Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

A 30-frame 160x120 run of the port's engine on the card (``odom_init="kp"``,
so the keypoint kernels run too) records the inputs each kernel saw at its
last frame (the first frame's compaction and a compaction frame's clean from
frames of their own); every test replays them through the kernel and the
plain version and holds them to the tolerances of
``multimotionfusion_tpu_torch.kernels.checks``, as chip_smoke.py does at
640x480 (the kernels build with -fmad=false, so where both evaluate the same
expression they round alike). ``nms_topk`` also runs on synthetic heat maps
(a plateau larger than K, random scores, a random-weight SuperPoint).

One SO(3) iteration (``so3_iteration``, one launch) must also equal its two
halves' standalone kernels (``so3_reduce``, ``so3_step``: the path no longer
launches them; their inputs come from the iteration's record) bit for bit,
and keep their tolerances against the plain versions.

A second 160x120 run, of the multi-model engine with external masks
(chip_smoke.py's five orbiting spheres, 24 frames: five spawns and a
compaction frame), records the inputs of the multi-model kernels at its
last frame (K11 per level with its owner prep, K5's M-wide steps, K12, K14
fuse and clean, K10 composite) and of the composite odometry loop, which
runs on the card against the plain loop on the CPU.

A third run, of the flow-CRF multi-model engine on tests/test_five_movers.py's
160x120 journey (chip_smoke.five_movers, 17 frames, no masks), records the
inputs of the segmentation's kernels at its last frame: K13, K15 (the whole
flow, one cluster launch, bit-equal), one K16 iteration and all ten, K17 and
K18's three stages;
and K21's two batches of the frame (the per-model seeds, the back-dating
fits) and the back-dating batch with every active track selected: every
row bit-equal to a one-fit launch, the batch within the one-fit check's
tolerances of the plain version. The engine's per-fit draws on a CUDA
generator must equal sequential ``torch.rand`` calls.

A fourth pair of runs records the relocalisation and loop-closure kernels:
tests/test_reloc.py's journey at 160x120 (K22's ÷4 frame, retrieval and
photometric check on the relocalising frame, the insertion on a frame that
inserts) and tests/test_loop_closure.py's drift journey at 160x120 (K23's
constraint points and map on the matching frame).

A fifth run, of the legacy CRF multi-model engine (``segmentation.mode="crf"``)
on chip_smoke.py's spheres at 160x120, records K4's error-image mode, K24a-c
(SLIC, the superpixel means and upsample, the superpixel CRF) and K17.
K24a and K24b also run on hand-made label images
(``checks.check_slic_cases``: a superpixel over many list chunks, empty
ones, labels five cells away, the edge cells; N = 1, 13 and 40 images), and
K17 on hand-made mask stacks (``checks.check_components_cases``). K5's solve
runs on hand-made systems through its test entry (``checks.check_solve_cases``:
bit-equal to the float32 emulation that ``tests/test_torch_gn_solve.py`` holds
to the reference). The append scan of K8's and K14's association kernels runs
on hand-made flags and owners through its test entries
(``checks.check_scan_cases``: exact against torch.cumsum), and every K4
evaluation's sums must be bit-equal to the block-order float32 sum of its
partials (``checks.check_gn``; both references are checked on the CPU by
``tests/test_torch_append_scan.py``). K18's finish must also give depth
statistics bit-equal to ``checks.seg_stats_emulated`` (the kernel's summation
order, held to the plain version by ``tests/test_torch_finish_topk.py``),
on the flow-CRF run's inputs and on ``checks.finish_cases``; K19's top-K runs
on ``checks.TOPK_CASES`` too. K1's filter and K2's two sides (every level in
one launch a side) also run on hand-made inputs (``checks.FILTER_CASES``,
``checks.PYRAMID_CASES``), and K10 and K14's clean on theirs
(``checks.SPLAT_CASES``, ``checks.CLEAN_FLAT_CASES``, bit-equal to the plain
versions), K11's owner prep (every level in one launch) on
``checks.OWNER_CASES`` (exact) and K18's unaries on ``checks.UNARY_CASES``.
"""

import pytest
import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig, SurfelConfig
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
from multimotionfusion_tpu_torch.io.readers import SyntheticLogReader
from multimotionfusion_tpu_torch.kernels import checks

CAM = CameraModel(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
FRAMES = 30
COMPACT_FRAME = 23  # runs at tick 24, a compaction frame (compact_every = 8)
LEVELS = (0, 1, 2)

CASES = (
    [("frame_maps.filter", checks.check_frame_depth),
     ("frame_maps.surfels", checks.check_frame_surfels)]
    + [(f"pyramid.frame.L{lvl}", lambda a, lvl=lvl: checks.check_pyramid_frame(a, lvl))
       for lvl in LEVELS]
    + [(f"pyramid.pred.L{lvl}", lambda a, lvl=lvl: checks.check_pyramid_pred(a, lvl))
       for lvl in LEVELS]
    + [("odo_init", checks.check_odo_init), ("so3_reduce", checks.check_so3_reduce),
       ("so3_step", checks.check_so3_step), ("so3_iteration", checks.check_so3_iteration),
       ("gn_step", checks.check_gn_step),
       ("track", checks.check_track), ("zbuffer", checks.check_zbuffer),
       ("fuse", checks.check_fuse), ("clean", checks.check_clean),
       ("clean.compact", checks.check_clean), ("compact", checks.check_compact),
       ("splat_resolve", checks.check_splat)]
    + [(f"gn_reduce.L{lvl}", lambda a, lvl=lvl: checks.check_gn(a, lvl)) for lvl in LEVELS]
    + [("patch_score", checks.check_patch_score), ("nms_topk", checks.check_nms_topk),
       ("patch_desc", checks.check_patch_desc), ("mutual_match", checks.check_mutual_match),
       ("track_update", checks.check_track_update), ("ransac_fit", checks.check_ransac),
       ("seed_select", checks.check_seed_select), ("sparse", checks.check_sparse)]
)
# whole-chain checks, no launch key of their own; the SO(3) iteration's halves,
# off the path (their inputs derived from the iteration's record)
NOT_KERNELS = ("track", "sparse", "so3_reduce", "so3_step")


def _capture_key(name: str) -> str:
    """Recorded inputs and launch key of a case (a pyramid side builds every
    level in one launch; its cases check one level each)."""
    return name.rsplit(".", 1)[0] if name.startswith("pyramid.") else name


@pytest.fixture(scope="module")
def captured():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    cfg = EngineConfig(camera=CAM, enable_multi_model=False, odom_init="kp",
                       surfels=SurfelConfig(max_surfels=1 << 16))
    frames = list(SyntheticLogReader(CAM, num_frames=FRAMES + 1))
    K.reset_launches()
    eng = MultiMotionFusionTorch(cfg, device="cuda")
    K.start_capture()
    eng.process_frame(frames[0])
    out = {"compact": K.stop_capture()["compact"]}
    for i in range(1, FRAMES + 1):
        if i in (COMPACT_FRAME, FRAMES):
            K.start_capture()
        eng.process_frame(frames[i])
        if i == COMPACT_FRAME:
            out["clean.compact"] = K.stop_capture()["clean.compact"]
        elif i == FRAMES:
            out.update(K.stop_capture())
    torch.cuda.synchronize()
    checks.derive_so3(out)
    for name, _ in CASES:
        if name not in NOT_KERNELS:
            assert K.LAUNCHES.get(_capture_key(name), 0) > 0, name
    return out


@pytest.mark.parametrize("name,check", CASES, ids=[n for n, _ in CASES])
def test_kernel_matches_plain(captured, name, check):
    key = _capture_key(name)
    r = check(checks.args(key, captured[key]))
    assert r["ok"], r


MULTI_FRAMES = 24
MULTI_CASES = (
    [("owner_prep", checks.check_owner_prep)]
    + [(f"gn_multi.L{lvl}", lambda a, lvl=lvl: checks.check_gn_multi(a, lvl)) for lvl in LEVELS]
    + [("multi_init", checks.check_multi_init), ("multi_seed", checks.check_multi_seed),
       ("multi_arbitrate", checks.check_multi_arbitrate),
       ("gn_step_multi", checks.check_gn_step_multi), ("multi_so3_step", checks.check_so3_step),
       ("multi_so3_iteration", checks.check_so3_iteration),
       ("multi_track", checks.check_multi_track), ("zbuffer.flat", checks.check_zbuffer_flat),
       ("fuse_flat", checks.check_fuse_flat), ("clean_flat", checks.check_clean_flat),
       ("splat_resolve.composite", checks.check_splat)]
)


def _multi_key(name: str) -> str:
    return name[len("multi_"):] if name.startswith("multi_so3_") else name


@pytest.fixture(scope="module")
def captured_multi():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    from chip_smoke import multi_frames

    cfg, frames = multi_frames(MULTI_FRAMES + 1, CAM, object_capacity=1 << 14,
                               max_surfels=1 << 16)
    K.reset_launches()
    eng = MultiMotionFusionTorch(cfg, device="cuda")
    for i, f in enumerate(frames):
        if i == MULTI_FRAMES:
            K.start_capture()
        eng.process_frame(f)
    out = checks.derive_so3(K.stop_capture())
    torch.cuda.synchronize()
    assert eng.finish()["active_objects"] == 5.0
    for name, _ in MULTI_CASES:
        if name not in ("multi_track", "multi_so3_step"):
            key = "so3_iteration" if name == "multi_so3_iteration" else name
            assert K.LAUNCHES.get(key, 0) > 0, name
    return out


@pytest.mark.parametrize("name,check", MULTI_CASES, ids=[n for n, _ in MULTI_CASES])
def test_multi_kernel_matches_plain(captured_multi, name, check):
    key = _multi_key(name)
    r = check(checks.args(key, captured_multi[key]))
    assert r["ok"], r


@pytest.mark.parametrize("kind", ["plateau", "random", "superpoint"])
def test_nms_topk_synthetic_heat(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = checks.check_nms_topk(checks.nms_inputs(kind, CAM.height, CAM.width, "cuda"))
    assert r["ok"], r


def test_components_global_scratch():
    """K17 on a 240x160 stack (32-cell tiles, four passes): kept cells and
    sizes exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = checks.check_components(checks.components_inputs(160, 240, "cuda"))
    assert r["ok"], r


def test_components_hand_made_stacks():
    """K17 on ``checks.component_cases`` at 480x640, 120x160 and 487x651 (a
    spiral across tile edges, equal sizes in different tiles, all-True,
    empty, the last cell alone, blobs) against the plain version on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = checks.check_components_cases("cuda")
    assert r["ok"], r


FLOW_CASES = (
    [("zbuffer.depths", checks.check_render_depths), ("flow", checks.check_flow),
     ("crf.iter", checks.check_crf_iteration),
       ("crf", checks.check_crf), ("components", checks.check_components),
       ("segment.unaries", checks.check_seg_unaries), ("segment.fuse", checks.check_seg_fuse),
       ("segment.finish", checks.check_seg_finish),
       ("ransac_fit.shared", checks.check_ransac_batch),
       ("ransac_fit.per_fit", checks.check_ransac_batch),
       ("ransac_fit.every_track", checks.check_ransac_batch)]
)


def _flow_key(name: str) -> str:
    """Recorded inputs of a flow-CRF case (K15 and K16 record once a frame)."""
    return name.split(".")[0] if name.startswith(("flow.", "crf.")) else name


@pytest.fixture(scope="module")
def captured_flow():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    from chip_smoke import five_movers

    cfg, frames = five_movers()
    K.reset_launches()
    eng = MultiMotionFusionTorch(cfg, device="cuda")
    for i, f in enumerate(frames):
        if i == len(frames) - 1:
            K.start_capture()
        eng.process_frame(f)
    out = checks.derive_backdating(K.stop_capture())
    torch.cuda.synchronize()
    assert eng.finish()["active_objects"] >= 1.0
    for key in ("zbuffer.depths", "flow", "crf.plan", "crf.iter", "components",
                "segment.unaries", "segment.fuse", "segment.finish", "ransac_fit"):
        assert K.LAUNCHES.get(key, 0) > 0, key
    return out


@pytest.mark.parametrize("name,check", FLOW_CASES, ids=[n for n, _ in FLOW_CASES])
def test_flow_crf_kernel_matches_plain(captured_flow, name, check):
    key = _flow_key(name)
    r = check(checks.args(key, captured_flow[key]))
    assert r["ok"], r


def test_draws_equal_sequential_on_card():
    """``ransac.draw_uniforms`` on a CUDA generator (a frame's 6 seed fits,
    then its 8 back-dating fits) equals 14 sequential ``torch.rand`` calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = checks.check_draws("cuda")
    assert r["ok"], r


GLOBAL_CASES = [("ferns.frame", checks.check_fern_frame),
                ("ferns.encode_hd", checks.check_fern_encode_hd),
                ("ferns.insert", checks.check_fern_insert), ("ferns.photo", checks.check_fern_photo),
                ("deform.points", checks.check_deform_points),
                ("deform.apply_map", checks.check_deform_apply)]


@pytest.fixture(scope="module")
def captured_global():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    import dataclasses

    import numpy as np
    from chip_smoke import drift_state, reloc_frames

    from multimotionfusion_tpu_torch.config import DeformationConfig, FernConfig
    from multimotionfusion_tpu_torch.io import synthetic
    from multimotionfusion_tpu_torch.io.frame import FrameData

    base = EngineConfig(camera=CAM, enable_multi_model=False, odom_init="",
                        surfels=SurfelConfig(max_surfels=1 << 16, depth_cutoff=5.0))
    cfg = dataclasses.replace(base, reloc_mode=True,
                              ferns=FernConfig(num_ferns=300, factor=4, max_depth=5.0))
    frames, _ = reloc_frames(CAM)
    eng = MultiMotionFusionTorch(cfg, device="cuda")
    out = {}
    for i, f in enumerate(frames):
        if i in (1, len(frames) - 1):
            K.start_capture()
        eng.process_frame(f)
        if i == 1:
            out["ferns.insert"] = K.stop_capture()["ferns.insert"]
        elif i == len(frames) - 1:
            out.update({k: v for k, v in K.stop_capture().items()
                        if k.startswith("ferns.") and k != "ferns.insert"})
    assert not bool(eng.state.lost)
    lcfg = dataclasses.replace(
        base, close_loops=True, surfels=dataclasses.replace(base.surfels, time_delta=3),
        ferns=FernConfig(num_ferns=200, factor=4), deformation=DeformationConfig(max_nodes=64))
    eng = MultiMotionFusionTorch(lcfg, device="cuda")
    gt = [synthetic.pose((0.0, 0.0015 * i, 0.0), (0.002 * i, 0.0, 0.0)) for i in range(6)]
    for i, T in enumerate(gt + [gt[0]]):
        if i == 6:
            eng.finish()
            D = np.eye(4, dtype=np.float32)
            D[:3, 3] = (0.03, -0.02, 0.01)
            eng.state = drift_state(eng.state, D)
            K.start_capture()
        depth, rgb = synthetic.render(T, CAM)
        eng.process_frame(FrameData(rgb=rgb.astype(np.uint8), depth=depth, timestamp=i))
    out.update({k: v for k, v in K.stop_capture().items() if k.startswith("deform.")})
    assert eng.pose_matches()[-1]["accepted"]
    return out


@pytest.mark.parametrize("name,check", GLOBAL_CASES, ids=[n for n, _ in GLOBAL_CASES])
def test_global_kernel_matches_plain(captured_global, name, check):
    r = check(checks.args(name, captured_global[name]))
    assert r["ok"], r


LEGACY_CASES = [("gn_reduce.error_images", checks.check_error_images),
                ("slic.centres", checks.check_slic_centres),
                ("slic.assign", checks.check_slic_assign),
                ("sp.downsample", checks.check_sp_means), ("sp.upsample", checks.check_sp_upsample),
                ("legacy_crf.plan", checks.check_lcrf_plan),
                ("legacy_crf.iterate[1]", lambda a: checks.check_lcrf_iterate(a, 1)),
                ("legacy_crf.iterate[10]", lambda a: checks.check_lcrf_iterate(a, 10)),
                ("components", checks.check_components)]


def _legacy_key(name: str) -> str:
    """Recorded inputs of a legacy CRF case (SLIC and the CRF record once a frame)."""
    if name.startswith("slic."):
        return "slic"
    return "legacy_crf.plan" if name.startswith("legacy_crf.") else name


@pytest.fixture(scope="module")
def captured_legacy():
    """A 160x120 run of the legacy CRF multi-model engine on chip_smoke.py's
    spheres (no masks, ``segmentation.mode="crf"``, 12 frames): the inputs
    of K4's error images, K24a-c and K17 at its last frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    import dataclasses

    from chip_smoke import multi_frames

    from multimotionfusion_tpu_torch.config import SegmentationConfig

    cfg, frames = multi_frames(12, cam=CAM, object_capacity=1 << 14, max_surfels=1 << 16,
                               masks=False)
    cfg = dataclasses.replace(cfg, segmentation=SegmentationConfig(mode="crf"))
    K.reset_launches()
    eng = MultiMotionFusionTorch(cfg, device="cuda")
    for i, f in enumerate(frames):
        if i == len(frames) - 1:
            K.start_capture()
        eng.process_frame(f)
    out = K.stop_capture()
    torch.cuda.synchronize()
    for key in ("gn_reduce.error_images", "slic.centres", "slic.assign", "sp.downsample",
                "sp.upsample", "legacy_crf.plan", "legacy_crf.iterate", "components"):
        assert K.LAUNCHES.get(key, 0) > 0, key
    return out


@pytest.mark.parametrize("name,check", LEGACY_CASES, ids=[n for n, _ in LEGACY_CASES])
def test_legacy_crf_kernel_matches_plain(captured_legacy, name, check):
    key = _legacy_key(name)
    r = check(checks.args(key, captured_legacy[key]))
    assert r["ok"], r


def test_slic_hand_made_labels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = checks.check_slic_cases("cuda")
    assert r["ok"], r


def test_solve_cases_bit_equal_to_emulation():
    """K5's ``solve_preconditioned<6>`` and ``<3>`` (``mmf_solve_cases``) on
    ``checks.solve_cases``: x and the eigenvalues bit-equal to
    ``checks.solve_preconditioned_emulated``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = checks.check_solve_cases("cuda")
    assert r["ok"], r


def test_fuse_scan_cases_exact():
    """K8's and K14's append scan (``mmf_fuse_scan_cases``,
    ``mmf_fuse_flat_scan_cases``) on ``checks.scan_cases``: prefix and counts
    exact against torch.cumsum."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = checks.check_scan_cases("cuda")
    assert r["ok"], r


@pytest.mark.parametrize("name", ["flow_cases", "track_cases", "match_cases", "finish_cases",
                                  "topk_cases"])
def test_k15_k20_hand_made_cases(name):
    """K15 on hand-made image pairs (640x480 at 1/4 and at 1/2, whose bands do
    not fit a block's shared memory, and 487x651 whose 121 CRF rows do not
    divide by the cluster), K20's update on
    hand-made tables (full, more new keypoints than free slots, all matched,
    none valid, the ring's wrap either way, no depth, no pair) and its match
    on hand-made descriptors (duplicates, invalid rows and columns, K and T
    off the tile), K18's finish on hand-made segment inputs (no new label, a
    new label hugging each border and one inside, objects at and one cell
    under the minimum-cells gate, a segment without depth, M = 16, 487x651)
    and K19's top-K on hand-made heat maps (fewer peaks than K, a negative
    conf_thresh, a plateau with more peaks than K, 487x651, K the pixel
    count): exact against the plain versions on the CPU; the finish's mean
    and std bit-equal to ``checks.seg_stats_emulated``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = getattr(checks, f"check_{name}")("cuda")
    assert r["ok"], r


@pytest.mark.parametrize("name", ["filter_cases", "pyramid_cases"])
def test_k1_k2_hand_made_cases(name):
    """K1's filter on ``checks.FILTER_CASES`` (487x651, 80x60, 17x23, 9x11,
    all-zero depth, depth at and beside min_d and max_d, millimetres and
    metres) and K2's two sides on ``checks.PYRAMID_CASES`` (the same sizes,
    model ids with mask_icp and mask_rgb on and off, use_rgb off, bf16 and
    f32 level-0 maps, two levels at 80x60) against the plain versions on the
    card, within the engine lines' tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = getattr(checks, f"check_{name}")("cuda")
    assert r["ok"], r


@pytest.mark.parametrize("name", ["splat_cases", "clean_flat_cases"])
def test_k10_k14_hand_made_cases(name):
    """K10 on ``checks.SPLAT_CASES`` (sizes off the 32 x 8 tile, windows 1,
    2, 3, 5 and 7, static, slot-pointer and composite modes, model
    boundaries inside every tile, exact and near depth ties, a tile without a
    surfel, fill-in with and without its gate, passthrough) and K14's clean,
    in place on a copy, on ``checks.CLEAN_FLAT_CASES`` (stale ALIVE past the
    counts, +0 and -0 ALIVE, penalties of exactly 1, redundancy and z culls,
    windows 4 and 5): every output bit-equal to the plain version on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = getattr(checks, f"check_{name}")("cuda")
    assert r["ok"], r


@pytest.mark.parametrize("name", ["owner_cases", "unaries_cases"])
def test_k11_k18_hand_made_cases(name):
    """K11's owner prep on ``checks.OWNER_CASES`` (487x651 and other sizes off
    the 32 x 8 tile, 1, 2 and 3 levels, owners hugging every border, no-owner
    ids, one model): every level's maps exact against the plain version on
    the card; K18's unaries on ``checks.UNARY_CASES`` (no track, no new
    label, a ragged grid, every track in one cell, 31 models): within
    ``check_seg_unaries``' tolerance (and 9,000 tracks, three rounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = getattr(checks, f"check_{name}")("cuda")
    assert r["ok"], r


@pytest.mark.parametrize("name", ["depth_cases", "score_cases"])
def test_k13_k19_hand_made_cases(name):
    """K13 on ``checks.DEPTH_CASES`` (every count 0, full buckets, one
    model, 31 slots, strides 1 and 2, one cell, the gates' and the
    projection's edges, a missed confidence gate, 122 x 163 cells): coverage
    exact, depth within one log-depth bin of the plain version on the card,
    the keys' scratch all KEY_INVALID after every call; K19's patch_score on
    ``checks.SCORE_CASES`` (487x651, 9x11, all border, constant, sign-flipping
    steps, sizes one off the 32 x 20 tile): bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    r = getattr(checks, f"check_{name}")("cuda")
    assert r["ok"], r
