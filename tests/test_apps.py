"""App-layer smoke tests (CPU, tiny configs).

Each app is exercised through its CLI entry point, mirroring how the
reference's three executables are its only user surface
(CMakeLists.txt:22-36).
"""
import os
import time

import numpy as np
import pytest

from tpuray.apps.rayview import MOVE_SPEED, ROT_SPEED, CameraController


class TestScenegen:
    def test_writes_reference_equivalent_archive(self, tmp_path, reference):
        from tpuray.apps import scenegen
        out = str(tmp_path / "render.map")
        scenegen.main(["--out", out])
        ours = open(out, "rb").read()
        ref = open(os.path.join(reference, "scenes", "render.map"),
                   "rb").read()
        assert len(ours) == len(ref) == 723
        # identical except the reference's uninitialized pad bytes
        diff = [i for i in range(723) if ours[i] != ref[i]]
        assert len(diff) <= 19 and all(ours[i] == 0 for i in diff)


class TestRayview:
    def test_camera_controller_matches_reference_keymap(self):
        """rayinteractive.c:32-104: WASD moves along dir/right at 0.1,
        arrows rotate spherical angles at 0.05, space/shift vertical."""
        c = CameraController(origin=(0, 0, 0), x_rot=np.pi / 2,
                             y_rot=np.pi / 2)
        # x_rot=pi/2, y_rot=pi/2 -> dir = (0, 0, 1)
        np.testing.assert_allclose(c.lookdir, [0, 0, 1], atol=1e-12)
        c.key("w")
        np.testing.assert_allclose(c.origin, [0, 0, MOVE_SPEED], atol=1e-12)
        c.key(" ")
        assert c.origin[1] == MOVE_SPEED
        c.key("4")
        assert c.y_rot == np.pi / 2 - ROT_SPEED
        c.key("8")
        assert c.x_rot == np.pi / 2 - ROT_SPEED
        # right = cross(world_up, -dir) = (-1,0,0) for dir=(0,0,1);
        # 'a' moves along -right (rayinteractive.c:60-63) -> +x
        c2 = CameraController(origin=(0, 0, 0), x_rot=np.pi / 2,
                              y_rot=np.pi / 2)
        c2.key("a")
        np.testing.assert_allclose(c2.origin, [MOVE_SPEED, 0, 0],
                                   atol=1e-12)
        c2.key("d")
        c2.key("d")
        np.testing.assert_allclose(c2.origin, [-MOVE_SPEED, 0, 0],
                                   atol=1e-12)
        # space/shift move along the perspective up vector
        # (cross(forward, right)), not world y, when the camera is pitched
        c3 = CameraController(origin=(0, 0, 0), x_rot=np.pi / 4,
                              y_rot=np.pi / 2)
        c3.key(" ")
        d = c3.lookdir
        fwd = -d
        right = np.cross([0.0, 1.0, 0.0], fwd)
        up = np.cross(fwd, right)
        np.testing.assert_allclose(c3.origin, up * MOVE_SPEED, atol=1e-12)

    def test_scripted_frames(self, tmp_path):
        from tpuray.apps import rayview
        frames = str(tmp_path / "frames")
        rayview.main(["--width", "64", "--height", "32", "--depth", "1",
                      "--keys", "w4", "--frames-dir", frames])
        assert sorted(os.listdir(frames)) == ["frame_0000.png",
                                              "frame_0001.png"]

    def test_serve_streams_frames_and_keys_drive_camera(self):
        """--serve: the browser live viewer.
        Drives the HTTP surface end to end — page, /key (camera moves,
        re-render triggered), /frame.jpg and one /stream part — with a
        stub renderer so the test needs no device."""
        import threading
        import urllib.request

        import numpy as np

        from tpuray.apps import rayview

        ctl = rayview.CameraController()
        calls = []

        def fake_frame():
            calls.append(tuple(ctl.origin))
            return np.full((32, 64, 3), len(calls) * 10, np.uint8)

        captured = {}

        def started(httpd, stop):
            captured["httpd"] = httpd
            captured["stop"] = stop
            captured["port"] = httpd.server_address[1]

        th = threading.Thread(
            target=rayview.serve,
            args=(ctl, fake_frame, 64, 32, 0),
            kwargs={"host": "127.0.0.1", "started": started}, daemon=True)
        th.start()
        for _ in range(100):
            if "port" in captured:
                break
            time.sleep(0.05)
        base = f"http://127.0.0.1:{captured['port']}"

        page = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"/stream" in page and b"ArrowUp" in page

        jpg = urllib.request.urlopen(f"{base}/frame.jpg", timeout=30).read()
        assert jpg[:2] == b"\xff\xd8"      # JPEG SOI
        o0 = ctl.origin.copy()
        msg = urllib.request.urlopen(f"{base}/key?k=w", timeout=10).read()
        assert b"origin=" in msg
        assert not np.allclose(ctl.origin, o0)   # 'w' moved the camera

        # one multipart frame from the MJPEG stream
        with urllib.request.urlopen(f"{base}/stream", timeout=30) as r:
            assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
            head = r.readline() + r.readline()
            assert b"--frame" in head or b"image/jpeg" in head

        captured["stop"].set()
        captured["httpd"].shutdown()
        th.join(timeout=10)
        assert len(calls) >= 2   # initial frame + re-render after 'w'


class TestRaypng:
    def test_tiny_offline_render(self, tmp_path):
        from tpuray.apps import raypng
        out = str(tmp_path / "out.png")
        raypng.main(["--width", "64", "--height", "32", "--depth", "1",
                     "--shadow-samples", "0", "--chunk-size", "0",
                     "--out", out, "--selfcheck"])
        from tpuray.io import read_png
        img = read_png(out)
        assert img.shape == (32, 64, 3)
        assert img.max() > 0  # rendered something


class TestInvrender:
    def test_two_optimization_steps_reduce_loss(self, tmp_path, capsys):
        from tpuray.apps import invrender
        ck = str(tmp_path / "inv.npz")
        invrender.main(["--steps", "2", "--width", "24", "--height", "16",
                        "--checkpoint", ck, "--every", "1"])
        assert os.path.exists(ck)
        out = capsys.readouterr().out
        assert "recovered vs truth" in out

    def test_pallas_engine_recovers(self, tmp_path):
        """engine='pallas' end to end (record preflight + replay-VJP
        steps) must actually RECOVER, not just run: a short smoke test
        could not catch a replay-gradient regression.  The GPU kernel runs
        in interpret mode here."""
        from tpuray.apps import invrender
        ck = str(tmp_path / "inv_p.npz")
        err0, err1, _, _ = invrender.main(
            ["--steps", "150", "--width", "48", "--height", "36",
             "--depth", "2", "--engine", "pallas", "--interpret",
             "--lr", "3e-2", "--light-lr-scale", "1.0",
             "--checkpoint", ck, "--every", "50"])
        assert err0 > 0.03
        # bar: 0.5 of the start error
        assert err1 < 0.5 * err0, (err0, err1)

    def test_recovers_render_map_params_within_tolerance(self, tmp_path):
        """Recover render.map's material params + light positions from the
        true scene's render, asserting the recovery actually converges —
        mean |recovered−truth| over the optimized leaves drops below 50%
        of the perturbed start.  Steps are cheap next to the compile, so
        the run is sized for a bar tight enough to catch a halved-quality
        regression."""
        from tpuray.apps import invrender
        ck = str(tmp_path / "inv.npz")
        err0, err1, obs0, obs1 = invrender.main(
            ["--steps", "120", "--width", "48", "--height", "36",
             "--depth", "2", "--checkpoint", ck, "--every", "60",
             "--engine", "xla"])
        assert err0 > 0.03  # the perturbation actually moved the params
        assert err1 < 0.5 * err0, (err0, err1)
