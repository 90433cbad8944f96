"""HTTP text-to-image server (port of ``tools/inference_server.py``).

``POST /predict`` with a JSON body (:class:`GenerationParams`) returns the
image as webp bytes; ``GET /health`` answers ``{"status": "ok"}``. A
micro-batcher folds concurrent seedless requests of one shape into one
sampler call. The model is the SDXL of a training config's ``model``
section (an NF4-prequantized checkpoint loads as such), with a trained LoRA
on top when ``--peft-path`` names one:

    python -m vision_pt_tpu_torch.tools.inference_server \\
        --config configs/sdxl/text_to_image_qlora_nf4.yml \\
        --peft-path lora.safetensors

``model.tokenizer`` in the config is a directory holding the two CLIP
tokenizers (``tokenizer/``, ``tokenizer_2/``) or ``word-hash``. The server
runs on the CUDA device unless ``--device`` names another, and serves on
the standard library's threaded HTTP server.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from io import BytesIO
from threading import Lock

import click
import yaml
from pydantic import BaseModel, field_validator
from torch import nn

DEFAULT_NEGATIVE = (
    "bad quality, worst quality, lowres, bad anatomy, sketch, jpeg "
    "artifacts, ugly, poorly drawn, signature, watermark"
)
WEBP_QUALITY = 90


class GenerationParams(BaseModel):
    prompt: str
    negative_prompt: str = DEFAULT_NEGATIVE
    inference_steps: int = 25
    cfg_scale: float = 6.5
    width: int = 768
    height: int = 1024
    seed: int | None = None

    @field_validator("width", "height")
    @classmethod
    def check_divisible_by_64(cls, value):
        if value % 64 != 0:
            raise ValueError(f"{value} is not divisible by 64")
        return value


class Batcher:
    """Micro-batching: the oldest queued request and the requests with the
    same key — (width, height, steps, cfg_scale) and seedlessness — that
    arrive within ``max_delay_ms`` run as ONE sampler call of up to
    ``max_batch`` prompts. A request with a seed runs alone: its noise comes
    from its own seed, which one batched draw cannot give each sample."""

    def __init__(self, generate_batch, max_batch: int = 8,
                 max_delay_ms: float = 60.0):
        self._generate_batch = generate_batch
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def batch_key(params: GenerationParams):
        return (
            params.width, params.height, params.inference_steps,
            params.cfg_scale,
            # None and 1 must not collide (True == 1 in Python): a seeded
            # request may never be folded into a seedless batch
            ("noseed",) if params.seed is None else ("seed", params.seed),
        )

    def submit(self, params: GenerationParams) -> Future:
        fut: Future = Future()
        self._q.put((params, fut))
        return fut

    def _collect(self):
        """One group: the oldest request plus same-key requests arriving
        within the delay window (the others are queued again)."""
        first_params, first_fut = self._q.get()
        group = [(first_params, first_fut)]
        if first_params.seed is not None:
            return group
        key = self.batch_key(first_params)
        t_end = time.monotonic() + self.max_delay
        requeue = []
        while len(group) < self.max_batch:
            timeout = t_end - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if self.batch_key(item[0]) == key:
                group.append(item)
            else:
                requeue.append(item)
        for item in requeue:
            self._q.put(item)
        return group

    def _loop(self):
        while True:
            group = self._collect()
            params = [p for p, _ in group]
            try:
                results = self._generate_batch(params)
                assert len(results) == len(group)
                for (_, fut), result in zip(group, results):
                    fut.set_result(result)
            except Exception as e:  # noqa: BLE001 - delivered per request
                for _, fut in group:
                    if not fut.done():
                        fut.set_exception(e)


def encode_webp(image) -> bytes:
    """The response body of one image."""
    buf = BytesIO()
    image.save(buf, format="WEBP", quality=WEBP_QUALITY)
    return buf.getvalue()


def load_peft(model, peft_path: str) -> list[str]:
    """Load a LoRA / LoHa file (sgm or comfy keys, as the trainers save
    them) onto ``model``'s modules; returns the adapted module paths."""
    from safetensors.torch import load_file

    from ..models.sdxl.convert import convert_from_original_key
    from ..peft import load_peft_weight

    tree = nn.Module()
    tree.denoiser = model.denoiser
    tree.text_encoder = nn.ModuleDict(dict(
        text_encoder_1=model.text_encoder.text_encoder_1,
        text_encoder_2=model.text_encoder.text_encoder_2))
    tree.vae = model.vae
    peft_dict = {convert_from_original_key(k): v.to(model.device)
                 for k, v in load_file(peft_path).items()}
    return load_peft_weight(tree, peft_dict)


class T2IModel:
    """The SDXL of a training config behind the batcher; one sampler call
    on the device at a time."""

    def __init__(self, config_path: str, peft_path: str | None = None,
                 max_batch: int = 8, max_delay_ms: float = 60.0,
                 device: str | None = None):
        from ..config import TrainConfig
        from ..models.sdxl import SDXLConfig, SDXLModel
        from ..models.sdxl.text_encoder import load_tokenizers

        with open(config_path) as f:
            config = TrainConfig(**yaml.safe_load(f))
        model_config = SDXLConfig.model_validate(config.model)
        tokenizer = config.model.get("tokenizer")
        if tokenizer is None:
            raise ValueError("model.tokenizer must name the CLIP tokenizers' "
                             "directory, or word-hash")
        tokenizer_1, tokenizer_2 = load_tokenizers(tokenizer)
        self.model = SDXLModel.from_checkpoint(
            model_config, device=device, tokenizer_1=tokenizer_1,
            tokenizer_2=tokenizer_2)
        self.batcher = Batcher(self._generate_batch, max_batch, max_delay_ms)
        if peft_path is not None:
            print(f"Loading PEFT weights from {peft_path}")
            load_peft(self.model, peft_path)
        self._lock = Lock()

    def _generate_batch(self, params_list: list[GenerationParams]) -> list[bytes]:
        """One sampler call for the whole group (the batcher guarantees
        matching width, height, steps and cfg; prompts and negatives vary
        per sample)."""
        head = params_list[0]
        with self._lock:
            images = self.model.generate(
                prompt=[p.prompt for p in params_list],
                negative_prompt=[p.negative_prompt for p in params_list],
                num_inference_steps=head.inference_steps,
                cfg_scale=head.cfg_scale,
                width=head.width,
                height=head.height,
                seed=head.seed,
            )
        return [encode_webp(image) for image in images]

    def generate(self, params: GenerationParams) -> bytes:
        return self.batcher.submit(params).result()


def make_handler(model: T2IModel):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, body: dict) -> None:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(json.dumps(body).encode())

        def do_POST(self):
            if self.path.rstrip("/") != "/predict":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                params = GenerationParams.model_validate_json(
                    self.rfile.read(length))
            except Exception as e:  # noqa: BLE001 - surface as 422
                self._json(422, {"error": str(e)})
                return
            try:
                body = model.generate(params)
            except Exception as e:  # noqa: BLE001 - surface as 500
                self._json(500, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/webp")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") == "/health":
                self._json(200, {"status": "ok"})
            else:
                self.send_error(404)

        def log_message(self, fmt, *args):
            print(f"[server] {fmt % args}")

    return Handler


def serve(model: T2IModel, host: str, port: int) -> ThreadingHTTPServer:
    """The bound server; the caller runs ``serve_forever`` (port 0 binds a
    free port, in ``server_address``)."""
    server = ThreadingHTTPServer((host, port), make_handler(model))
    print(f"Serving on http://{host}:{server.server_address[1]} "
          "(POST /predict, GET /health)")
    return server


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--peft-path", type=str, default=None)
@click.option("--host", type=str, default="0.0.0.0")
@click.option("--port", type=int, default=8123)
@click.option("--device", type=str, default=None,
              help="cuda (the default) or cpu")
def main(config_path: str, peft_path: str | None, host: str, port: int,
         device: str | None):
    model = T2IModel(config_path, peft_path, device=device)
    serve(model, host, port).serve_forever()


if __name__ == "__main__":
    main()
