"""SimpleSIFT: canonical two-image detect + match example.

Port of the reference's usage example (TestWin/SimpleSIFT.cpp:78-289):
detect features on two images, match them, report the pairs. Also shows the
remote mode (reference CreateRemoteSiftGPU) via RemoteSift.

    python examples/simple_sift.py [img1 img2] [--remote]

Without image paths it matches two seeded 800x600 views of one scene.
"""

import sys

sys.path.insert(0, ".")


def main():
    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    use_remote = "--remote" in sys.argv

    if len(argv) >= 2:
        img1, img2 = argv[:2]
    else:
        from hessgpu_tpu.sfm.synthetic import scene_views
        img1, img2 = scene_views(0, 600, 800, positions=(0.45, 0.55))

    if use_remote:
        from hessgpu_tpu.parallel.client import RemoteSift
        with RemoteSift() as remote:
            remote.initialize()
            run = remote.run_sift if isinstance(img1, str) \
                else remote.run_sift_data
            run(img1)
            keys1, des1 = remote.get_feature_vector()
            run(img2)
            keys2, des2 = remote.get_feature_vector()
            remote.match_set_descriptors(0, des1)
            remote.match_set_descriptors(1, des2)
            matches = remote.match()
    else:
        from hessgpu_tpu import HessianSift, SiftConfig, SiftMatcher
        sift = HessianSift(SiftConfig())
        f1 = sift.run(img1)
        print(f"image 1: {f1['x'].shape[0]} features")
        f2 = sift.run(img2)
        print(f"image 2: {f2['x'].shape[0]} features")
        matcher = SiftMatcher()
        matches = matcher.match(f1, f2)

    print(f"{len(matches)} matches")
    for i, j in matches[:10]:
        print(f"  {i} -> {j}")


if __name__ == "__main__":
    main()
