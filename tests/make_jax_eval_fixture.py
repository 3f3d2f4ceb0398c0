"""Write tests/fixtures/jax_eval_flagship_synth_val100.json: the JAX
package's evaluation of the committed flagship, the reference the PyTorch
port's evaluator is held to (tests/test_torch_eval.py on the CPU, the
`evaluate` phase of chip_smoke.py on the GPU).

    JAX_PLATFORMS=cpu python tests/make_jax_eval_fixture.py

It generates the 100 val scenes of the seed-0 synthetic set
(`generate_synthetic_coco(seed=0)`) in a temporary directory and evaluates
`weights/flagship_tinyvgg.npz` (Lightweight-OpenPose on VggTiny) there with
`hyperpose_tpu.eval.evaluate.Evaluator` at 368x432, batch 8, in float32 on
the CPU. The file holds the metrics, every detection (COCO results) and
the sha256 of the val annotation file, of each val JPEG and of each
decoded RGB array (`cv2.imread` -> RGB), with the OpenCV version that wrote
and read them: JPEG coders of other OpenCV builds may give other bytes.
This script imports JAX; the port's files read only its output.
"""
import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_eval_flagship_synth_val100.json")
WEIGHTS = os.path.join(REPO, "weights", "flagship_tinyvgg.npz")
INPUT_HW = (368, 432)
BATCH = 8
N_VAL = 100
SEED = 0


def sha256_file(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def image_hashes(root: str) -> tuple[str, dict, dict]:
    """sha256 of the val annotation file, and of each val JPEG and its
    decoded RGB array, by file name."""
    import cv2

    ann = os.path.join(root, "annotations", "person_keypoints_val2017.json")
    jpeg, rgb = {}, {}
    for name in sorted(os.listdir(os.path.join(root, "val2017"))):
        path = os.path.join(root, "val2017", name)
        jpeg[name] = sha256_file(path)
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        rgb[name] = hashlib.sha256(img.tobytes()).hexdigest()
    return sha256_file(ann), jpeg, rgb


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=FIXTURE)
    args = p.parse_args()

    import cv2
    import jax

    jax.config.update("jax_platforms", "cpu")
    from hyperpose_tpu import config as Config
    from hyperpose_tpu import models as Model
    from hyperpose_tpu.data.base import get_dataset
    from hyperpose_tpu.data.synthetic import generate_synthetic_coco
    from hyperpose_tpu.eval.evaluate import Evaluator
    from hyperpose_tpu.train.checkpoint import load_weights_npz

    with tempfile.TemporaryDirectory() as root:
        generate_synthetic_coco(root, n_train=0, n_val=N_VAL, seed=SEED, emit_mpii=False)
        ann_sha, jpeg, rgb = image_hashes(root)
        Config.reset()
        Config.set_model_type(Config.MODEL.LightweightOpenpose)
        Config.set_model_backbone(Config.BACKBONE.Vggtiny)
        Config.set_compute_dtype("float32")
        Config.set_dataset_path(root)
        cfg = Config.get_config(create_dirs=False)
        model = Model.get_model(cfg)
        dataset = get_dataset(cfg)
        variables = model.init(jax.random.PRNGKey(0),
                               jax.numpy.zeros((1, *INPUT_HW, 3)), train=False)
        variables = load_weights_npz(variables, WEIGHTS)
        results = []
        official_eval = dataset.official_eval

        def capture(pd_annotations, eval_dir):
            results.extend(pd_annotations)
            return official_eval(pd_annotations, eval_dir)

        dataset.official_eval = capture
        ev = Evaluator(model, variables, dataset, INPUT_HW, dataset.output_converter,
                       Model.get_topology(cfg), batch_size=BATCH)
        t0 = time.perf_counter()
        metrics = ev.evaluate(limit=N_VAL, eval_dir=os.path.join(root, "eval"))
        seconds = time.perf_counter() - t0

    out = {
        "about": "hyperpose_tpu Evaluator, weights/flagship_tinyvgg.npz "
                 "(LightweightOpenpose, Vggtiny), float32 on the CPU, "
                 f"{INPUT_HW[0]}x{INPUT_HW[1]}, batch {BATCH}, the {N_VAL} val "
                 f"scenes of generate_synthetic_coco(seed={SEED}); written by "
                 "tests/make_jax_eval_fixture.py",
        "input_hw": list(INPUT_HW), "batch": BATCH, "n_val": N_VAL, "seed": SEED,
        "jax_version": jax.__version__, "opencv_version": cv2.__version__,
        "seconds": seconds,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "annotation_sha256": ann_sha,
        "jpeg_sha256": jpeg, "rgb_sha256": rgb,
        "detections": results,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out}: {len(results)} detections, metrics {out['metrics']}")


if __name__ == "__main__":
    main()
