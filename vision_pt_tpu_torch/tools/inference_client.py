"""Client of the inference server (port of ``tools/inference_client.py``):
a Gradio UI when ``gradio`` is installed, or one request from the command
line with ``--once``:

    python -m vision_pt_tpu_torch.tools.inference_client \\
        --server http://localhost:8123 --once --prompt "photo of a cat"
"""

from __future__ import annotations

import json
import time
import urllib.request
from io import BytesIO

import click
from PIL import Image


def generate_image(server: str, prompt: str, negative_prompt: str,
                   width: int, height: int, num_inference_steps: int,
                   cfg_scale: float, seed: int | None = None):
    """POST one request to ``server``'s ``/predict`` (with ``seed`` when one
    is given); returns ([the decoded image], a status line with the elapsed
    seconds)."""
    params = {
        "prompt": prompt,
        "negative_prompt": negative_prompt,
        "width": width,
        "height": height,
        "inference_steps": num_inference_steps,
        "cfg_scale": cfg_scale,
    }
    if seed is not None:
        params["seed"] = seed
    body = json.dumps(params).encode()
    req = urllib.request.Request(
        f"{server}/predict", data=body,
        headers={"Content-Type": "application/json"},
    )
    start = time.time()
    with urllib.request.urlopen(req) as resp:
        data = resp.read()
    elapsed = time.time() - start
    return [Image.open(BytesIO(data))], f"Elapsed time: {elapsed:.2f} s"


def build_ui(server: str):
    import gradio as gr

    with gr.Blocks() as ui:
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label="Prompt",
                                    placeholder="photo of a cat", lines=4)
                negative_prompt = gr.Textbox(label="Negative prompt", lines=2)
                with gr.Row():
                    width = gr.Slider(256, 2048, value=768, step=64,
                                      label="Width")
                    height = gr.Slider(256, 2048, value=1024, step=64,
                                       label="Height")
                steps = gr.Slider(1, 50, value=25, step=1, label="Steps")
                cfg = gr.Slider(0.0, 15.0, value=6.5, step=0.5,
                                label="CFG scale")
                run = gr.Button("Generate")
            with gr.Column():
                gallery = gr.Gallery(label="Images")
                status = gr.Textbox(label="Status")
        run.click(
            lambda *a: generate_image(server, *a),
            inputs=[prompt, negative_prompt, width, height, steps, cfg],
            outputs=[gallery, status],
        )
    return ui


@click.command()
@click.option("--server", type=str, default="http://localhost:8123")
@click.option("--host", type=str, default="127.0.0.1")
@click.option("--once", is_flag=True,
              help="send one request from the CLI instead of launching the UI")
@click.option("--prompt", type=str, default="photo of a cat")
@click.option("--save-path", type=str, default="client_output.webp")
def main(server, host, once, prompt, save_path):
    if once:
        images, status = generate_image(
            server, prompt, "", 768, 768, 20, 5.0
        )
        images[0].save(save_path)
        print(f"{status}; saved to {save_path}")
        return
    try:
        ui = build_ui(server)
    except ImportError:
        raise SystemExit(
            "gradio is not installed in this environment; use --once for a "
            "CLI request"
        )
    ui.launch(server_name=host)


if __name__ == "__main__":
    main()
