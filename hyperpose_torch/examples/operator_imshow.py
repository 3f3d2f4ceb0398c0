"""Operator-API example: live imshow inference from a camera or video.

Counterpart of `examples/operator_imshow.py` (reference:
examples/operator_api_imshow_{paf,pose_proposal}.example.cpp — frame-by-frame
inference with an OpenCV display window; --post selects the parser family).
"""
import argparse

from hyperpose_torch import Config, Model
from hyperpose_torch.examples import POST_TO_MODEL, engine_for
from hyperpose_torch.utils.human import draw_humans


def main(argv=None):
    import cv2

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default="0", help="camera index or video path")
    ap.add_argument("--post", choices=sorted(POST_TO_MODEL), default="paf")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--no_display", action="store_true",
                    help="run headless (decode only, no cv2.imshow)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    Config.reset()
    Config.set_model_type(Config.MODEL[POST_TO_MODEL[args.post]])
    cfg = Config.get_config(create_dirs=False)
    engine = engine_for(cfg, args.weights, args.device, max_batch_size=1)
    print(f"warmup: {engine.warmup():.1f}s")
    topo = Model.get_topology(cfg)

    src = int(args.source) if args.source.isdigit() else args.source
    cap = cv2.VideoCapture(src)
    frames = 0
    while True:
        ok, frame = cap.read()
        if not ok or (args.limit and frames >= args.limit):
            break
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        out = draw_humans(rgb, engine.inference([rgb])[0], topo)
        frames += 1
        if not args.no_display:
            cv2.imshow("hyperpose-torch", cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
    cap.release()
    if not args.no_display:
        cv2.destroyAllWindows()
    print(f"{frames} frames, {engine.stats.fps:.1f} model fps")


if __name__ == "__main__":
    main()
