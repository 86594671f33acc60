"""Interactive annotation GUI (reference `seg_annotator.py`; PyTorch
counterpart of ``gan_segmentation_tpu/apps/annotator.py``, with the same
names and button handlers).

tkinter canvas brush annotator over GAN samples: left-drag paints positive
(white) strokes, CTRL-drag paints negative (gray #808080), mouse wheel
resizes the brush, CTRL-Z undoes the last stroke. Buttons:
OK (save + next), Skip, Retrain (decoder fit with live mask-overlay
preview), Generate (emit the synthetic dataset), Reset.

Saved triples use the reference's on-disk format
(`seg_annotator.py:322-337`): ``mask_%06d.png`` rasterized strokes on black
(=> trimap: 255 pos / 128 neg / 0 ignore), ``img_%06d.jpg``,
``vis_img_%06d.jpg``, ``feat_%06d.pickle`` (CHW float32 arrays readable by
the reference tools).

The stroke model and rasterization live in ``StrokeBuffer`` so they are
testable headless; the tk widgets are a thin shell around it.  ``tkinter``,
PIL and cv2 are imported where they are used, so the module imports
without them.  Generate builds a ``FusedPipeline`` on the solver Retrain
has just fitted; the pipeline folds the decoder's batch norm from the
solver's current weights (``SegSolver.weights_version``). Keycodes
37/50/64/52 (ctrl/alt/shift/z) follow the reference's X11 bindings
(`seg_annotator.py:121-125`).
"""

import pickle
import random
import time
from os import makedirs
from os.path import isdir, join
from typing import List, Optional, Tuple

import numpy as np

from ..train.generator import ImageGenerator
from ..train.solver import SegSolver
from ..utils.viz import get_draw_mask

POSITIVE_COLOR = "#ffffff"
NEGATIVE_COLOR = "#808080"


class Stroke:
    """One drag segment: optional connecting line + end-cap circles."""

    def __init__(self, line, start_cap, end_cap):
        self.line = line          # (x0, y0, x1, y1, width, color) | None
        self.start_cap = start_cap  # (xs0, ys0, xs1, ys1, color) | None
        self.end_cap = end_cap      # same | None


class StrokeBuffer:
    """Headless stroke history + rasterization (`seg_annotator.py:104-118`)."""

    def __init__(self):
        self.history: List[Stroke] = []
        self.has_changes = False
        self._prev_pos: Optional[Tuple[int, int]] = None
        self._down_id: Optional[int] = None
        self._up_id: Optional[int] = None

    def mouse_down(self, pos, width: float, negative: bool):
        self._down_id = len(self.history)
        return self.add_point(pos, width, negative)

    def mouse_up(self):
        self._up_id = len(self.history)
        self._prev_pos = None

    def add_point(self, pos, width: float, negative: bool) -> Stroke:
        color = NEGATIVE_COLOR if negative else POSITIVE_COLOR
        w = int(width)
        x1, y1 = pos
        if self._prev_pos is not None:
            x0, y0 = self._prev_pos
            stroke = Stroke(
                (x0, y0, x1, y1, w, color),
                (x0 - w // 2, y0 - w // 2, x0 + w // 2, y0 + w // 2, color),
                (x1 - w // 2, y1 - w // 2, x1 + w // 2, y1 + w // 2, color))
        else:
            stroke = Stroke(
                None,
                (x1 - w // 2, y1 - w // 2, x1 + w // 2, y1 + w // 2, color),
                None)
        self.history.append(stroke)
        self.has_changes = True
        self._prev_pos = pos
        return stroke

    def undo_last_action(self) -> int:
        """Remove the strokes of the last press..release drag; returns the
        number removed (`seg_annotator.py:131-135`)."""
        if self._up_id is None or self._down_id is None:
            return 0
        n = min(len(self.history), self._up_id - self._down_id)
        if n > 0:
            self.history = self.history[:-n]
            self._up_id = self._down_id
        return max(0, n)

    def reset(self):
        self.history = []
        self.has_changes = False
        self._prev_pos = None
        self._down_id = None
        self._up_id = None

    def rasterize(self, width: int, height: int) -> np.ndarray:
        """Strokes on black -> gray trimap png payload (uint8 HW)."""
        from PIL import Image, ImageDraw
        img = Image.new("RGB", (width, height), (0, 0, 0))
        draw = ImageDraw.Draw(img)
        for s in self.history:
            if s.line is not None:
                x0, y0, x1, y1, w, color = s.line
                draw.line([x0, y0, x1, y1], color, width=w)
            for cap in (s.start_cap, s.end_cap):
                if cap is not None:
                    xs0, ys0, xs1, ys1, color = cap
                    draw.ellipse([xs0, ys0, xs1, ys1], fill=color, outline=None)
        return np.asarray(img)[:, :, 0].copy()


def save_annotation(dst_dir: str, image_id: int, img_orig: np.ndarray,
                    vis_img: np.ndarray, mask_gray: np.ndarray,
                    features_nhwc: List[np.ndarray]):
    """Write one annotated triple in the reference's format."""
    import cv2
    cv2.imwrite(join(dst_dir, f"mask_{image_id:06d}.png"), mask_gray)
    cv2.imwrite(join(dst_dir, f"img_{image_id:06d}.jpg"), img_orig[:, :, ::-1])
    cv2.imwrite(join(dst_dir, f"vis_img_{image_id:06d}.jpg"),
                vis_img[:, :, ::-1])
    chw = [np.ascontiguousarray(np.transpose(f, (2, 0, 1)), np.float32)
           for f in features_nhwc]
    with open(join(dst_dir, f"feat_{image_id:06d}.pickle"), "wb") as fp:
        pickle.dump(chw, fp)


class SegmentationAnnotator:
    """tk.Frame-based annotator; construct with a Tk root like the reference
    (`main.py:45-53`)."""

    def __init__(self, parent, root_dir, gan_dir="stylegan-models",
                 gan="ffhq", n_generate=10000, gan_batch_size=4,
                 max_res_log2=None, **_compat):
        import tkinter as tk
        self._tk = tk
        self.frame = tk.Frame(parent)
        parent.title("Image Viewer")

        self.root_dir = root_dir
        self.n_generate = n_generate
        self.initialize_dirs()

        fram = tk.Frame(self.frame)
        fram.pack(side=tk.BOTTOM, fill=tk.BOTH)
        self.ok_btn = tk.Button(fram, text="OK", command=self.on_ok_clicked)
        self.skip_btn = tk.Button(fram, text="Skip", command=self.on_skip_clicked)
        self.retrain_btn = tk.Button(fram, text="Retrain",
                                     command=self.on_train_clicked)
        self.generate_btn = tk.Button(fram, text="Generate",
                                      command=self.on_generate_clicked)
        self.reset_btn = tk.Button(fram, text="Reset",
                                   command=self.on_reset_clicked)
        for b in (self.ok_btn, self.skip_btn, self.retrain_btn,
                  self.generate_btn, self.reset_btn):
            b.pack(side=tk.RIGHT)

        self.can = tk.Canvas(self.frame, cursor="none")
        self.can.bind("<Motion>", self.on_mouse_move)
        self.can.bind("<ButtonPress-1>", self.on_mouse_down)
        self.can.bind("<ButtonRelease-1>", self.on_mouse_up)
        self.can.bind("<Button-4>", self.on_mouse_wheel)
        self.can.bind("<Button-5>", self.on_mouse_wheel)
        self.can.bind("<Leave>", self.on_mouse_leave)
        self.can.pack()
        parent.bind("<KeyPress>", self.on_key_down)
        parent.bind("<KeyRelease>", self.on_key_up)

        self.mouse_is_down = False
        self.width = 20.0
        self.ctrl = self.alt = self.shift = False
        self.cursor = None
        self.prev_cursor_pos = (None, None)
        self.strokes = StrokeBuffer()
        self._canvas_items: List[List] = []

        self.netG = ImageGenerator(gan=gan, gan_dir=gan_dir,
                                   batch_size=gan_batch_size,
                                   max_res_log2=max_res_log2)
        self.solver = SegSolver(self.netG.cfg.max_res_log2,
                                join(root_dir, "data"),
                                join(root_dir, "checkpoints"))
        self.image_iterator = self.create_image_iterator()
        self.generate_btn.config(
            state="normal" if self.solver.is_trained else "disabled")
        self.next_image()

    def pack(self, **kw):
        self.frame.pack(**kw)
        return self

    # ------------------------------------------------------------- input
    def on_key_down(self, event):
        k = event.keycode
        self.ctrl = self.ctrl or k == 37
        self.alt = self.alt or k == 50
        self.shift = self.shift or k == 64
        if self.ctrl:
            self.update_cursor()
        if k == 52 and self.ctrl:  # ctrl-z
            removed = self.strokes.undo_last_action()
            for items in self._canvas_items[len(self._canvas_items) - removed:]:
                for cid in items:
                    self.can.delete(cid)
            if removed:
                self._canvas_items = self._canvas_items[:-removed]

    def on_key_up(self, event):
        k = event.keycode
        prev_ctrl = self.ctrl
        if k == 37:
            self.ctrl = False
        if k == 50:
            self.alt = False
        if k == 64:
            self.shift = False
        if prev_ctrl != self.ctrl:
            self.update_cursor()

    def on_mouse_wheel(self, event):
        coeff = 1.2 if event.num == 4 else 1 / 1.2
        self.width = max(1.0, min(200.0, self.width * coeff))
        self.update_cursor()

    def on_mouse_leave(self, event):
        self.update_cursor(event, disable=True)

    def update_cursor(self, event=None, disable=False):
        if self.cursor is not None:
            self.can.delete(self.cursor)
            self.cursor = None
        if disable:
            return
        color = "#f0f0f0" if not self.ctrl else "#8f8f8f"
        x, y = ((event.x, event.y) if event is not None
                else self.prev_cursor_pos)
        if x is None:
            return
        r = int(self.width / 2)
        self.cursor = self.can.create_oval(x - r, y - r, x + r, y + r,
                                           outline=color, width=3)
        self.prev_cursor_pos = (x, y)

    def _render_stroke(self, stroke: Stroke):
        display = stroke.start_cap[4] if stroke.start_cap else POSITIVE_COLOR
        ids = []
        if stroke.line is not None:
            x0, y0, x1, y1, w, color = stroke.line
            ids.append(self.can.create_line(x0, y0, x1, y1, width=w,
                                            fill=color))
        for cap in (stroke.start_cap, stroke.end_cap):
            if cap is not None:
                xs0, ys0, xs1, ys1, color = cap
                ids.append(self.can.create_oval(xs0, ys0, xs1, ys1,
                                                fill=color, width=0))
        self._canvas_items.append(ids)

    def on_mouse_move(self, event):
        self.update_cursor(event)
        if self.mouse_is_down:
            self._render_stroke(self.strokes.add_point(
                (event.x, event.y), self.width, self.ctrl))

    def on_mouse_down(self, event):
        self.mouse_is_down = True
        self._render_stroke(self.strokes.mouse_down(
            (event.x, event.y), self.width, self.ctrl))

    def on_mouse_up(self, event):
        self.mouse_is_down = False
        self.strokes.mouse_up()

    # ------------------------------------------------------------ actions
    def on_train_clicked(self):
        if self.strokes.has_changes:
            self.save_current_results()
        self.toggle_disable_main()
        time.sleep(1)

        def epoch_end_callback():
            mask = self.solver.predict(self.features)[0].astype(np.uint8)
            img = get_draw_mask(self.img_orig, mask[:, :, 0], alpha=0.5)
            self.set_img(img)

        self.solver.fit(epoch_end_callback)
        print("train finished.")
        self.toggle_disable_main(True)
        self.reset_history()

    def on_reset_clicked(self):
        self.set_img(self.img_orig)
        self.reset_history()

    def toggle_disable_main(self, enabled=False):
        state = "normal" if enabled else "disabled"
        for b in (self.ok_btn, self.skip_btn, self.retrain_btn):
            b.config(state=state)
        self.generate_btn.config(
            state=state if self.solver.is_trained else "disabled")

    def on_skip_clicked(self):
        self.next_image()

    def on_ok_clicked(self):
        if self.strokes.has_changes:
            self.save_current_results()
        self.next_image()

    def on_generate_clicked(self):
        from ..train.generator import FusedPipeline
        import cv2
        self.toggle_disable_main(enabled=False)
        dst_dir = join(self.root_dir, "dataset", "train_generated")
        if not isdir(dst_dir):
            makedirs(dst_dir)
        pipeline = FusedPipeline(self.netG, self.solver)
        for i, (img, mask) in enumerate(
                pipeline.generate_pairs(self.n_generate)):
            cv2.imwrite(join(dst_dir, f"img_{i:06d}.jpg"), img[:, :, ::-1])
            cv2.imwrite(join(dst_dir, f"mask_{i:06d}.png"), mask)
        self.toggle_disable_main(enabled=True)

    def initialize_dirs(self):
        for subdir in ("data", "checkpoints", "dataset"):
            if not isdir(join(self.root_dir, subdir)):
                makedirs(join(self.root_dir, subdir))

    def create_image_iterator(self, buffer_size=2):
        while True:
            for img, features in self.netG.get_images(buffer_size):
                mask = (self.solver.predict(features)[0].astype(np.uint8)
                        if self.solver.is_trained else None)
                yield img, mask, features

    def save_current_results(self):
        h, w = self.img_orig.shape[:2]
        mask_gray = self.strokes.rasterize(w, h)
        save_annotation(join(self.root_dir, "data"), self.image_id,
                        self.img_orig, self.vis_img, mask_gray, self.features)

    def next_image(self):
        img_orig, mask, features = next(self.image_iterator)
        vis_img = np.array(img_orig)
        if mask is not None:
            vis_img = get_draw_mask(img_orig, mask[:, :, 0],
                                    alpha=0.5).astype(np.uint8)
        self.image_id = random.randint(0, 1000000)
        self.img_orig = img_orig
        self.vis_img = vis_img
        self.features = features
        self.set_img(vis_img)
        self.reset_history()

    def set_img(self, img):
        from PIL import Image, ImageTk
        self.img_frame = ImageTk.PhotoImage(Image.fromarray(img))
        self.can.config(bg="#000000", width=self.img_frame.width(),
                        height=self.img_frame.height())
        self.can.create_image(0, 0, image=self.img_frame,
                              anchor=self._tk.NW)
        self._canvas_items = []
        self.can.update()

    def reset_history(self):
        self.strokes.reset()
