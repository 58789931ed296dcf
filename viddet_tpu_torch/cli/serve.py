"""Detection serving CLI: an HTTP service over the continuous batcher
(counterpart of ``viddet_tpu/cli/serve.py``).

Loads the model once, warms it with one request, then serves concurrent
detection requests, fused into shared device batches by
``infer/service.py``'s ``DetectionService`` on one card.

Endpoints:
  GET  /healthz          -> {"status": "ok", model/class info, counters}
  POST /detect           -> body = encoded image (JPEG, PNG, BMP, WebP,
                            GIF, PNM / PAM, TIFF, Sun raster, PFM,
                            Radiance HDR or JPEG 2000, as cv2.imdecode
                            reads them);
                            optional ?thresh=0.5 query overrides the default;
                            reply  = {"width", "height", "detections":
                            [{"class_id", "class_name", "score",
                              "box": [x1, y1, x2, y2]}]}   (original coords)

An upload the port's codec cannot decode gets a 400: a truncated or
corrupt file, an AVIF image (a format cv2 reads and the port does not yet),
or a variant of a format the port refuses (an RLEW-compressed TIFF, an
HTJ2K codestream, say), named in the reply.  ``--quant int8``
calibrates on ``--calib-images`` before serving, as ``cli.detect`` does.

Example, on the card:
  python -m viddet_tpu_torch.cli.serve --network yolo3_darknet53 --dataset coco \
      --weights weights.npz --port 8000 --batch-size 16 &
  (add ``--quant int8 --calib-images calib/`` for int8 convs)
  curl -s --data-binary @image.jpg http://127.0.0.1:8000/detect
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from viddet_tpu_torch.cli.common import (
    add_quant_flags,
    build_model,
    load_weights_or_seed,
    make_predictor,
    parse_with_config,
    platform_device,
    quant_policy_kw,
    setup_logging,
)
from viddet_tpu_torch.data.base import decode_rgb
from viddet_tpu_torch.data.transforms import ValTransform
from viddet_tpu_torch.infer.service import DetectionService


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve detection over HTTP.")
    p.add_argument("--network", default="yolo3_darknet53")
    p.add_argument("--dataset", default="voc", help="class set: voc|coco|vid")
    p.add_argument("--weights", default="",
                   help=".npz weights; if empty, seeded random weights (seed 0)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--data-shape", type=int, default=416)
    p.add_argument("--thresh", type=float, default=0.5,
                   help="default score threshold (per-request ?thresh= wins)")
    p.add_argument("--batch-size", type=int, default=8,
                   help="device batch = max requests fused per dispatch")
    p.add_argument("--flush-ms", type=float, default=5.0,
                   help="max wait to fill a batch once one request is held")
    p.add_argument("--request-timeout", type=float, default=30.0)
    add_quant_flags(p)
    p.add_argument("--calib-images", default="",
                   help="image file or directory for --quant int8 range calibration "
                        "(required with --quant)")
    return parse_with_config(p, argv)


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Encoded image bytes (JPEG, PNG, BMP, WebP, GIF or PNM / PAM) ->
    upright RGB uint8, as ``cv2.imdecode`` and a BGR-to-RGB swap give it;
    ValueError otherwise."""
    return decode_rgb(data, "upload")


def detections_to_json(ids, scores, boxes, class_names, thresh: float) -> dict:
    dets = []
    for cid, s, bb in zip(ids, scores, boxes):
        if cid < 0 or s < thresh:
            continue
        dets.append({
            "class_id": int(cid),
            "class_name": class_names[int(cid)],
            "score": round(float(s), 4),
            "box": [round(float(v), 2) for v in bb],
        })
    return {"detections": dets}


def make_handler(service: DetectionService, class_names, default_thresh: float,
                 request_timeout: float, info: dict, logger):
    t_start = time.time()

    class Handler(BaseHTTPRequestHandler):
        # one service; handler instances are per-connection (threaded server)
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *fa):  # through the logger, quietly
            logger.debug("http: " + fmt, *fa)

        def _reply(self, code: int, payload: dict):
            if code != 200:
                # an error path may leave the body unread, and an unread
                # body would parse as the next request line on a kept-alive
                # connection: close it instead
                self.close_connection = True
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, {
                "status": "ok",
                "uptime_s": round(time.time() - t_start, 1),
                **service.stats(),
                **info,
            })

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/detect":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    return self._reply(400, {"error": "empty body"})
                rgb = decode_image_bytes(self.rfile.read(n))
            except Exception as exc:  # noqa: BLE001 -- client error
                return self._reply(400, {"error": str(exc)})
            q = parse_qs(url.query)
            try:
                thresh = float(q["thresh"][0]) if "thresh" in q else default_thresh
            except ValueError:
                return self._reply(400, {"error": "bad thresh"})
            try:
                ids, scores, boxes = service.detect(rgb, timeout=request_timeout)
            except TimeoutError:
                return self._reply(503, {"error": "request timed out"})
            except Exception as exc:  # noqa: BLE001 -- server error
                logger.exception("inference failed")
                return self._reply(500, {"error": str(exc)})
            out = detections_to_json(ids, scores, boxes, class_names, thresh)
            out["width"], out["height"] = rgb.shape[1], rgb.shape[0]
            self._reply(200, out)

    return Handler


def serve_forever(args, logger, built=None) -> ThreadingHTTPServer:
    """Build model, service and HTTP server; returns the started server
    (``server.viddet_service`` is its service).  Split from ``main`` so a
    caller can run the whole stack on an ephemeral port and shut it down.
    ``built``: a caller's (model, class names), weights loaded, instead of
    the model that ``args`` names."""
    device = platform_device(args.platform)
    if built is None:
        model, class_names = build_model(args.network, args.dataset, device=device,
                                         **quant_policy_kw(args))
        load_weights_or_seed(model, args.weights)
    else:
        model, class_names = built
    transform = ValTransform(size=(args.data_shape, args.data_shape),
                             letterbox_resize=True, normalize=False)
    if args.quant:
        from viddet_tpu_torch.cli.detect import calibrate_for_detect

        calibrate_for_detect(model, args, transform, logger)
    infer = make_predictor(model)
    service = DetectionService(infer, transform, batch_size=args.batch_size,
                               flush_ms=args.flush_ms, device=device)
    # one request before traffic, so the first client does not pay the
    # cuDNN algorithm choice and the kernel build (the same dispatch path)
    t0 = time.time()
    service.detect(np.zeros((args.data_shape, args.data_shape, 3), np.uint8))
    logger.info("model warm in %.1fs", time.time() - t0)

    info = {
        "network": args.network,
        "dataset": args.dataset,
        "num_classes": len(class_names),
        "batch_size": args.batch_size,
        "data_shape": args.data_shape,
    }
    handler = make_handler(service, class_names, args.thresh, args.request_timeout, info,
                           logger)
    server = ThreadingHTTPServer((args.host, args.port), handler)
    server.viddet_service = service
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    logger.info("serving %s/%s on http://%s:%d (batch %d, flush %.1fms)",
                args.network, args.dataset, args.host, server.server_address[1],
                args.batch_size, args.flush_ms)
    return server


def main(argv=None):
    import signal

    args = parse_args(argv)
    logger = setup_logging()
    server = serve_forever(args, logger)
    stop = threading.Event()
    # SIGTERM is how a supervisor stops a service: drain as on ctrl-C
    # (requests in flight settle, queued ones get a clean error)
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(3600)
    except KeyboardInterrupt:
        pass
    logger.info("shutting down")
    server.shutdown()
    server.server_close()
    server.viddet_service.close()


if __name__ == "__main__":
    main()
