"""The `tcforge` command-line interface.

Rebuild of the reference's CLI surface (``src/cmdline_def.h``, 144
options expanded via X-macros): same single-letter option semantics for
the transform chain (-j, -I, -X, -B, -Z, -Y, -r, -z, -l, -k, -K, -G, -C),
sources/sinks (-i, -o, -p, -m), filters (-J), ranges (-c), colorspace
(-V), rate control (-f) and audio (-s, -E, -d).

Usage:  python -m tcforge_tpu.cli -i in.y4m -J hqdn3d,unsharp=luma=0.8 \
            -Z 640x480 -o out.y4m
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from tcforge_tpu import __version__
from tcforge_tpu.core import log
from tcforge_tpu.core.codecs import ContainerFormat
from tcforge_tpu.core.formats import format_from_string
from tcforge_tpu.core.framecode import parse_ranges
from tcforge_tpu.core.job import FilterSpec, Job


def _parse_clip(text: str):
    """-j T[,L[,B[,R]]] with omitted values mirroring the reference
    (L defaults to T, B to T, R to L)."""
    parts = [int(x) for x in text.split(",")]
    t = parts[0]
    l = parts[1] if len(parts) > 1 else t
    b = parts[2] if len(parts) > 2 else t
    r = parts[3] if len(parts) > 3 else l
    return (t, l, b, r)


def _parse_pair(text: str, sep: str = "x"):
    a, b = text.split(sep, 1)
    return int(a), int(b)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tcforge",
        description="accelerator-native stream processing (transcode rebuild)")
    p.add_argument("-v", "--version", action="version",
                   version=f"tcforge_tpu {__version__}")
    # files
    p.add_argument("-i", dest="video_in", action="append",
                   help="input file / directory (repeatable: sources "
                   "chain in order)")
    p.add_argument("-p", dest="audio_in", help="separate audio input")
    p.add_argument("-o", dest="video_out", help="output file")
    p.add_argument("-m", dest="audio_out", help="separate audio output")
    # modules
    p.add_argument("-x", "--import_with", dest="im_modules", default="auto,auto",
                   help="import modules vmodule[,amodule]")
    p.add_argument("-y", "--export_with", dest="ex_modules", default="raw,raw,auto",
                   help="export modules venc[,aenc[,mux]]")
    p.add_argument("-F", "--export_param", dest="ex_v_fcc", default="",
                   help="video encoder option string (module-specific, "
                   "e.g. gop_n=12:gop_m=3)")
    p.add_argument("-N", dest="export_codec", default="",
                   help="export codecs vformat[,aformat] (selects "
                   "encoder modules by format name)")
    p.add_argument("-w", dest="bitrate",
                   help="video bitrate kbps[,keyframes] (enables rate "
                   "control)")
    p.add_argument("--video_max_bitrate", type=int, default=0,
                   help="maximum bitrate for VBR MPEG-2 (VBV cap) "
                   "[same as -w]")
    p.add_argument("--quantizers", default="",
                   help="min,max quantizer for MPEG-like codecs [2,31]")
    p.add_argument("--encode_fields", default="",
                   help="field-based encoding: t (top-first), b "
                   "(bottom-first), p (progressive), u (unknown)")
    p.add_argument("--pulldown", action="store_true",
                   help="set MPEG 3:2 pulldown flags on export")
    p.add_argument("-R", dest="multipass",
                   help="multipass mode n[,logfile] (1=analyze 2=encode)")
    p.add_argument("-O", dest="encoder_noflush", action="store_true",
                   help="do not flush buffered frames on encoder stop")
    # geometry / rate (for headerless input)
    p.add_argument("-g", "--frame_size", dest="geometry", help="input WxH for raw input")
    p.add_argument("-f", "--import_fps", dest="fps", type=float, help="input fps override")
    p.add_argument("--export_fps", dest="export_fps", type=float,
                   default=0.0, help="output fps (for fps/modfps filters)")
    # transform chain
    p.add_argument("--pre_clip", dest="pre_clip",
                   help="initial region clip T[,L[,B[,R]]] (before "
                   "all filters)")
    p.add_argument("-j", dest="im_clip", help="clip T[,L[,B[,R]]]")
    p.add_argument("-I", dest="deinterlace", type=int, default=0,
                   help="deinterlace mode 1..5")
    p.add_argument("-X", dest="resize_up", help="expand by n rows, m cols of M px [0,0,32]")
    p.add_argument("-B", dest="resize_down",
                   help="shrink by n rows, m cols of M px [0,0,32]")
    p.add_argument("-Z", dest="zoom", help="zoom WxH (slow, filtered)")
    p.add_argument("--zoom_filter", default="lanczos3",
                   help="zoom filter (lanczos3|bell|box|mitchell|...)")
    p.add_argument("-Y", dest="ex_clip", help="export clip T[,L[,B[,R]]]")
    p.add_argument("-r", dest="reduce", help="reduce n[,m]")
    p.add_argument("-z", dest="flip_v", action="store_true",
                   help="flip vertically")
    p.add_argument("-l", dest="flip_h", action="store_true", help="mirror")
    p.add_argument("-k", dest="rgbswap", action="store_true",
                   help="swap red/blue")
    p.add_argument("-K", dest="decolor", action="store_true",
                   help="grayscale")
    p.add_argument("-G", dest="gamma", type=float, default=0.0,
                   help="gamma correction")
    p.add_argument("-C", dest="antialias", type=int, default=0,
                   help="antialias mode 1..3")
    p.add_argument("--antialias_para", default="",
                   help="antialias center pixel weight, xy-bias "
                   "[0.333,0.500]")
    p.add_argument("--post_clip", dest="post_clip",
                   help="final region clip T[,L[,B[,R]]] (after all "
                   "filters)")
    # filters
    p.add_argument("-J", dest="filters", action="append", default=[],
                   help="filter chain: name[=opts][,name...]")
    # colorspace / ranges
    p.add_argument("-V", dest="colorspace", default="yuv420p",
                   help="internal colorspace (yuv420p|rgb24|yuv422p)")
    p.add_argument("-c", dest="ranges",
                   help="encode ranges S-E[/step][,...] (times or frames)")
    p.add_argument("--frame_interval", type=int, default=1,
                   help="encode every Nth frame")
    p.add_argument("--max_frames", type=int, help="stop after N frames")
    p.add_argument("-L", "--vob_seek", dest="vob_offset", type=int, default=0,
                   help="seek: skip the first N source frames")
    p.add_argument("-S", dest="seek_unit", default=None,
                   help="seek unit[,chunks] (program-stream units)")
    p.add_argument("-H", dest="probe_amount", type=int, default=0,
                   help="probe depth hint in MB (0 = default)")
    p.add_argument("--nav_seek", dest="nav_seek",
                   help="tcdemux nav index file for frame-exact "
                   "MPEG seeking")
    p.add_argument("-W", dest="autosplit", default="",
                   help="autosplit: process chunk n of m "
                   "(n,m[,navfile])")
    p.add_argument("--cluster_chunks", default="",
                   help="process chunk range a-b instead of one chunk")
    p.add_argument("--cluster_percentage", action="store_true",
                   help="-W values are percentages")
    p.add_argument("--psu_chunks", default="",
                   help="process only units a-b in PSU mode")
    p.add_argument("--no_split", action="store_true",
                   help="encode to a single file in chapter/PSU mode")
    p.add_argument("-T", dest="dvd_title", default="",
                   help="DVD title[,chapters[,angle]] (DVD access is "
                   "gated: needs libdvdread)")
    p.add_argument("-U", dest="chapter_mode", default="",
                   help="DVD chapter mode output base (gated: needs "
                   "libdvdread)")
    p.add_argument("--ts_pid", default="",
                   help="transport stream video pid (hex)")
    p.add_argument("--mplayer_probe", action="store_true",
                   help="probe with external mplayer (not in this "
                   "build; builtin probe is used)")
    p.add_argument("--import_asr", type=int, default=0,
                   help="override the probed input aspect code")
    # audio
    p.add_argument("-s", "--audio_scale", dest="volume", type=float, default=1.0,
                   help="volume scale")
    p.add_argument("-E", dest="resample", default="0",
                   help="audio output rate[,bits[,channels]]")
    p.add_argument("-e", dest="import_afmt", default="",
                   help="import audio rate[,bits[,channels]] "
                   "[48000,16,2]")
    p.add_argument("-n", dest="import_codec", default="",
                   help="import audio codec id (hex, e.g. 0x2000)")
    p.add_argument("-b", dest="abitrate", default="",
                   help="audio encoder bitrate kbps[,vbr[,quality"
                   "[,mode]]] [128,0,5,0]")
    p.add_argument("-A", dest="audio_use_ac3", action="store_true",
                   help="use AC3 as internal audio codec")
    p.add_argument("-d", "--audio_swap", dest="channels", type=int, default=0,
                   help="output channels")
    p.add_argument("-D", "--sync_frame", dest="av_offset", type=int, default=0,
                   help="A/V shift in frames (audio delay)")
    p.add_argument("-a", dest="a_track", type=int, default=0,
                   help="audio track to extract")
    p.add_argument("--av_fine_ms", type=int, default=0,
                   help="sub-frame A/V shift in milliseconds")
    p.add_argument("--sync", dest="sync_method", default="adjust",
                   choices=["none", "adjust"],
                   help="A/V synchronizer method")
    p.add_argument("-M", dest="demuxer_sync", type=int, default=1,
                   help="demuxer sync mode (accepted for parity)")
    p.add_argument("--resync_margin", type=int, default=1,
                   help="max A/V drift in frames before resync [1]")
    p.add_argument("--resync_interval", type=int, default=25,
                   help="check A/V sync every N frames [25]")
    p.add_argument("--no_audio_adjust", action="store_true",
                   help="disable audio frame size adjustment")
    # engine tuning
    p.add_argument("--batch", type=int, default=16,
                   help="frames per device batch")
    p.add_argument("--prefetch", type=int, default=2,
                   help="host prefetch depth")
    p.add_argument("--rotate_frames", type=int, default=0,
                   help="rotate output every N frames (name-%%03d)")
    p.add_argument("--rotate_mb", type=int, default=0,
                   help="rotate output every N megabytes")
    p.add_argument("--avi_limit", type=int, default=0,
                   help="split AVI output every N megabytes")
    p.add_argument("-t", "--split_time", type=float, default=0.0,
                   help="rotate output every N seconds")
    p.add_argument("--split_size", type=int, default=0,
                   help="split output file after N MB")
    p.add_argument("--avi_comments", dest="avi_comments",
                   help="file of 'TAG text' lines -> AVI LIST INFO")
    p.add_argument("-Q", dest="quality", type=int, default=5,
                   help="encoding quality 1..5 (stored; module hint)")
    p.add_argument("-P", dest="passthrough", type=int, default=0,
                   help="pass-through mode (1=video: -y copy)")
    p.add_argument("--progress_rate", type=float, default=0.5,
                   help="progress meter update interval (seconds)")
    p.add_argument("--nice", dest="niceness", type=int, default=0,
                   help="renice the process")
    p.add_argument("--write_pid", dest="write_pid",
                   help="write the process id to this file")
    p.add_argument("--config_dir", dest="config_dir",
                   help="extra export-profile search directory")
    p.add_argument("--accel", dest="accel", default="",
                   help="acceleration: default = native C++ fast "
                   "paths + XLA; 'none'/'C' forces the pure "
                   "jax/python paths (the reference's SIMD-level "
                   "selector role)")
    p.add_argument("-u", "--buffers", dest="buffers", default="",
                   help="frame ring depth N[,d,e] (maps to --prefetch)")
    p.add_argument("--threads", type=int, default=0,
                   help="accepted for parity (the batch dimension and "
                   "XLA replace filter worker threads)")
    p.add_argument("--progress_meter", type=int, default=1,
                   help="progress meter type (0 = off)")
    p.add_argument("--no_log_color", action="store_true",
                   help="disable colors in log messages")
    p.add_argument("--a52_demux", action="store_true",
                   help="(gated) demux AC3/A52 to separate channels")
    p.add_argument("--a52_drc_off", action="store_true",
                   help="(gated) disable AC3 dynamic range compression")
    p.add_argument("--a52_dolby_off", action="store_true",
                   help="(gated) disable AC3 Dolby surround")
    p.add_argument("--dv_yv12_mode", action="store_true",
                   help="(gated) force YV12 for PAL DV decode")
    p.add_argument("--dv_yuy2_mode", action="store_true",
                   help="(gated) use YUY2 for PAL DV decode")
    p.add_argument("--multi_input", action="store_true",
                   help="multiple-input (directory) core mode")
    p.add_argument("--export_asr", type=int, default=0,
                   help="output aspect ratio code")
    p.add_argument("--export_par", default="",
                   help="output pixel aspect num,den")
    p.add_argument("--export_frc", type=int, default=0,
                   help="output frame rate code")
    p.add_argument("--hard_fps", action="store_true",
                   help="force the -f rate over the probed one")
    p.add_argument("--debug", dest="debug_channels", default="",
                   help="debug channels: threads,sync,counter,private,"
                   "cleanup,modules,flist or 'all'")
    p.add_argument("--socket", dest="socket_path",
                   help="runtime control socket path")
    p.add_argument("--mesh", dest="mesh_mode", default="auto",
                   choices=["auto", "off"],
                   help="device-mesh execution over multiple chips")
    p.add_argument("--psu_mode", action="store_true",
                   help="process MPEG program stream units separately "
                   "(-o needs %%d)")
    p.add_argument("--psu_first", type=int, default=0,
                   help="first PSU to process")
    p.add_argument("--psu_last", type=int, default=-1,
                   help="last PSU to process (exclusive; -1 = all)")
    p.add_argument("--export_prof", dest="export_prof", default="",
                   help="export profile name[,name...] (vcd-pal, dvd-ntsc...)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--progress_off", action="store_true")
    p.add_argument("--list_filters", action="store_true",
                   help="list registered modules and exit")
    return p


def args_to_job(args: argparse.Namespace) -> Job:
    job = Job()
    vin = args.video_in
    if isinstance(vin, list):
        vin = vin[0] if len(vin) == 1 else vin
    job.video_in_file = vin
    job.audio_in_file = args.audio_in
    job.video_out_file = args.video_out
    job.audio_out_file = args.audio_out

    def _mod_opts(spec: str):
        # "-x module=optstring" (cmdline_def.h:473: vob->im_v_string)
        name, _, opts = spec.partition("=")
        return name, opts

    im_mods = (args.im_modules + ",auto").split(",")
    job.im_v_module, job.im_v_string = _mod_opts(im_mods[0])
    job.im_a_module, job.im_a_string = _mod_opts(im_mods[1])
    ex_mods = (args.ex_modules + ",raw,auto").split(",")
    job.ex_v_module, job.ex_v_string = _mod_opts(ex_mods[0])
    job.ex_a_module, job.ex_a_string = _mod_opts(ex_mods[1])
    job.ex_m_module, job.ex_m_string = _mod_opts(ex_mods[2])

    if args.geometry:
        job.im_v_width, job.im_v_height = _parse_pair(args.geometry)
    if args.fps:
        job.fps = args.fps
    if args.export_fps:
        job.ex_fps = args.export_fps
    if args.pre_clip:
        job.pre_im_clip = _parse_clip(args.pre_clip)
    if args.im_clip:
        job.im_clip = _parse_clip(args.im_clip)
    if args.post_clip:
        job.post_ex_clip = _parse_clip(args.post_clip)
    job.deinterlace = args.deinterlace
    # -X/-B take n[,m[,M]] with multiplier M in {8,16,32}, default 32
    # (cmdline_def.h --expand/--shrink); job units are 8-px rows/cols
    def _resize_units(spec: str):
        parts = [int(x) for x in spec.split(",")]
        n = parts[0]
        m = parts[1] if len(parts) > 1 else 0
        mult = parts[2] if len(parts) > 2 else 32
        if mult not in (8, 16, 32):
            raise SystemExit(
                "invalid multiplier for -X/-B (must be 8, 16, or 32)")
        return (m * mult // 8, n * mult // 8)

    if args.resize_up:
        job.resize_up = _resize_units(args.resize_up)
    if args.resize_down:
        job.resize_down = _resize_units(args.resize_down)
    if args.zoom:
        job.zoom_width, job.zoom_height = _parse_pair(args.zoom)
    job.zoom_filter = args.zoom_filter
    if args.ex_clip:
        job.ex_clip = _parse_clip(args.ex_clip)
    if args.reduce:
        parts = [int(x) for x in args.reduce.split(",")]
        job.reduce_h = parts[0]
        job.reduce_w = parts[1] if len(parts) > 1 else parts[0]
    job.flip_v = args.flip_v
    job.flip_h = args.flip_h
    job.rgbswap = args.rgbswap
    job.decolor = args.decolor
    job.gamma = args.gamma
    job.antialias = args.antialias
    if args.antialias_para:
        w, b = args.antialias_para.split(",")
        job.antialias_weight = float(w)
        job.antialias_bias = float(b)
    job.im_colorspace = format_from_string(args.colorspace)

    for chain in args.filters:
        for part in chain.split(","):
            if part.strip():
                job.filters.append(FilterSpec.parse(part.strip()))

    job.volume = args.volume
    # -E rate[,bits[,channels]] (export_afmt, cmdline_def.h:898)
    eparts = str(args.resample).split(",")
    job.mp3frequency = int(eparts[0] or 0)
    if len(eparts) > 1 and eparts[1]:
        job.dm_bits = int(eparts[1])
    if len(eparts) > 2 and eparts[2]:
        job.dm_chan = int(eparts[2])
    # -e rate[,bits[,channels]] (import_afmt, cmdline_def.h:556)
    if args.import_afmt:
        parts = args.import_afmt.split(",")
        job.a_rate = int(parts[0])
        if len(parts) > 1 and parts[1]:
            job.a_bits = int(parts[1])
        if len(parts) > 2 and parts[2]:
            job.a_chan = int(parts[2])
    if args.import_codec:
        job.a_codec_flag = int(args.import_codec, 16)
    if args.abitrate:
        parts = args.abitrate.split(",")
        job.mp3bitrate = int(parts[0])
        if len(parts) > 1 and parts[1]:
            job.a_vbr = int(parts[1])
        if len(parts) > 2 and parts[2]:
            job.mp3quality = float(parts[2])
        if len(parts) > 3 and parts[3]:
            job.mp3mode = int(parts[3])
    if args.audio_use_ac3:
        from tcforge_tpu.core.codecs import Codec
        job.im_a_codec = Codec.AC3
    job.av_offset = args.av_offset
    job.sync_method = args.sync_method
    job.resync_margin = args.resync_margin
    job.resync_interval = args.resync_interval
    job.no_audio_adjust = args.no_audio_adjust
    if args.channels:
        job.dm_chan = args.channels
    job.frame_interval = args.frame_interval
    job.max_frames = args.max_frames
    job.batch_size = args.batch
    job.prefetch_depth = args.prefetch
    job.rotate_frames = args.rotate_frames
    job.rotate_mb = args.rotate_mb
    job.socket_path = args.socket_path
    job.mesh_mode = args.mesh_mode
    job.export_profiles = args.export_prof

    job.ex_v_fcc = args.ex_v_fcc
    if args.bitrate:
        parts = args.bitrate.split(",")
        job.bitrate = int(parts[0])
        if len(parts) > 1 and parts[1]:
            job.keyframes = int(parts[1])
        job.rc_requested = True
    job.video_max_bitrate = args.video_max_bitrate
    if args.quantizers:
        mn, mx = args.quantizers.split(",")
        job.min_quantizer, job.max_quantizer = int(mn), int(mx)
        if not (1 <= job.min_quantizer <= 31
                and 1 <= job.max_quantizer <= 31):
            raise ValueError("--quantizers values must be in 1..31")
    if args.encode_fields:
        codes = {"p": 0, "t": 1, "b": 2, "u": 3}
        if args.encode_fields not in codes:
            raise ValueError("--encode_fields takes t, b, p or u")
        job.encode_fields = codes[args.encode_fields]
    job.pulldown = args.pulldown
    job.encoder_flush = not args.encoder_noflush
    job.ex_codec_names = args.export_codec
    if args.multipass:
        parts = args.multipass.split(",")
        job.divxmultipass = int(parts[0])
        if len(parts) > 1 and parts[1]:
            job.divxlogfile = parts[1]
        elif job.divxmultipass:
            job.divxlogfile = "divx4.log"
    job.vob_offset = args.vob_offset
    if args.seek_unit:
        job.seek_unit = int(args.seek_unit.split(",")[0])
    job.probe_amount = args.probe_amount
    job.avi_limit = args.avi_limit
    job.a_track = args.a_track
    job.av_fine_ms = args.av_fine_ms
    job.avi_comments_file = args.avi_comments
    job.quality = args.quality
    if args.passthrough:
        job.ex_v_module = "copy"
    if args.export_asr:
        job.ex_asr = args.export_asr
    if args.export_frc:
        job.ex_frc = args.export_frc
    if args.export_par:
        parts = args.export_par.split(",")
        if len(parts) == 2:
            job.ex_par = (int(parts[0]), int(parts[1]))
    if args.buffers:
        job.prefetch_depth = int(args.buffers.split(",")[0])
    if args.threads:
        log.info("tcforge", "--threads accepted: the batch dimension "
                 "and XLA threading replace filter worker threads")
    if args.nav_seek:
        job.nav_seek_file = args.nav_seek
    if args.split_size:
        job.rotate_mb = args.split_size
    if args.ts_pid:
        job.ts_pid1 = int(args.ts_pid, 16)
    if args.dvd_title:
        # -T t[,c[-d][,a]] (cmdline_def.h:340)
        parts = args.dvd_title.split(",")
        job.dvd_title = int(parts[0])
        if len(parts) > 1 and parts[1]:
            ch = parts[1].split("-")
            job.dvd_chapter1 = int(ch[0])
            if len(ch) > 1 and ch[1]:
                job.dvd_chapter2 = int(ch[1])
        if len(parts) > 2 and parts[2]:
            job.dvd_angle = int(parts[2])
    if args.import_asr:
        job.im_asr = args.import_asr
    job.a52_mode = ((1 if args.a52_demux else 0)
                    | (2 if args.a52_drc_off else 0)
                    | (4 if args.a52_dolby_off else 0))
    job.dv_yuy2_mode = args.dv_yuy2_mode and not args.dv_yv12_mode
    if args.mplayer_probe:
        log.warn("tcforge", "--mplayer_probe: no external mplayer in "
                 "this build; using the builtin probe")
    if args.no_log_color:
        log.set_color(False)
    if args.niceness:
        try:
            os.nice(args.niceness)
        except OSError as e:
            log.warn("tcforge", "nice failed: %s", e)
    if args.write_pid:
        with open(args.write_pid, "w") as f:
            f.write(str(os.getpid()))
    if args.config_dir:
        from tcforge_tpu.pipeline import export_profile
        export_profile.add_profile_dir(args.config_dir)
    job.hard_fps = args.hard_fps
    job.progress_rate = args.progress_rate
    if args.debug_channels:
        names = {"threads": log.DEBUG_THREADS, "sync": log.DEBUG_SYNC,
                 "counter": log.DEBUG_COUNTER,
                 "private": log.DEBUG_PRIVATE,
                 "cleanup": log.DEBUG_CLEANUP,
                 "modules": log.DEBUG_MODULES, "flist": log.DEBUG_FLIST}
        mask = 0
        for name in args.debug_channels.split(","):
            name = name.strip().lower()
            if name == "all":
                mask = sum(names.values())
            elif name in names:
                mask |= names[name]
            else:
                log.warn("tcforge", "unknown debug channel %r "
                         "(known: %s, all)", name, ",".join(names))
        log.set_debug_channels(mask)
    return job


import contextlib


@contextlib.contextmanager
def _sigint_drains(pipe):
    """^C -> cooperative drain (runcontrol.c:103 tc_interrupt /
    transcode.c §shutdown): first SIGINT sets the interrupt flag so
    the reader exits, encoders flush and muxers close with the
    summary printed; a second SIGINT aborts hard."""
    import signal

    def _on_int(signum, frame):
        if pipe.interrupted.is_set():
            raise KeyboardInterrupt
        log.warn("tcforge", "interrupt — draining (^C again to abort)")
        pipe.interrupted.set()
        pipe.paused.clear()

    try:
        old = signal.signal(signal.SIGINT, _on_int)
    except ValueError:          # not the main thread (embedded use)
        old = None
    try:
        yield
    finally:
        if old is not None:
            signal.signal(signal.SIGINT, old)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.accel.lower() in ("none", "c"):
        from tcforge_tpu import native
        native.disable()
        log.info("tcforge", "--accel %s: native fast paths disabled",
                 args.accel)
    if args.quiet:
        log.set_verbosity(log.LogLevel.WARN)
    if args.progress_meter == 0:
        args.progress_off = True
    if args.chapter_mode:
        log.error("tcforge", "-U chapter mode needs DVD access "
                  "(libdvdread is not in this build); transcode the "
                  "copied VOB files instead")
        return 1

    import tcforge_tpu.modules  # registers built-ins
    from tcforge_tpu import backend
    backend.init_compile_cache()

    if args.list_filters:
        from tcforge_tpu.modules.registry import list_modules
        for name in list_modules():
            print(name)
        return 0

    if not args.video_in:
        print("missing input file (-i); see --help", file=sys.stderr)
        return 1

    job = args_to_job(args)

    # autoprobe (src/probe.c probe_source analogue); multi-source and
    # directory inputs probe their first file
    if job.video_in_file and job.video_in_file != "test://":
        from tcforge_tpu.io.probe import probe_file, probe_to_job
        try:
            from tcforge_tpu.modules.importers.multi import \
                expand_sources
            srcs = expand_sources(job.video_in_file)
            info = probe_file(srcs[0], probe_mb=job.probe_amount)
            probe_to_job(info, job)
            if len(srcs) > 1 and not args.max_frames:
                job.max_frames = None   # first file's length != total
            log.info("probe", "%s", info.describe())
        except Exception as e:
            log.warn("probe", "probe failed (%s); relying on -g/-f/-x", e)
    else:
        job.im_v_format = ContainerFormat.TEST
        job.im_v_module = ("framegen" if job.im_v_module == "auto"
                           else job.im_v_module)

    # -e/-n: explicit import-audio overrides win over the probe
    # (reference preset flags, probe.c:395 TC_PROBE_NO_* semantics)
    if args.import_afmt:
        parts = args.import_afmt.split(",")
        job.a_rate = int(parts[0])
        if len(parts) > 1 and parts[1]:
            job.a_bits = int(parts[1])
        if len(parts) > 2 and parts[2]:
            job.a_chan = int(parts[2])

    if job.export_profiles:
        from tcforge_tpu.pipeline.export_profile import apply_profiles
        try:
            apply_profiles(job.export_profiles, job)
        except FileNotFoundError as e:
            log.error("tcforge", "%s", e)
            return 1

    # -N: select encoder modules by format name when -y left at default
    if job.ex_codec_names:
        from tcforge_tpu.modules.registry import module_name_for_format
        names = job.ex_codec_names.split(",")
        if args.ex_modules == "raw,raw,auto":    # -y not given
            vmod = module_name_for_format("encoder", names[0])
            if vmod is None:
                log.error("tcforge", "-N: no encoder for format %r",
                          names[0])
                return 1
            job.ex_v_module = vmod
            if len(names) > 1 and names[1]:
                amod = module_name_for_format("encoder", names[1])
                if amod is None and names[1].lower() != "pcm":
                    log.error("tcforge", "-N: no encoder for format %r",
                              names[1])
                    return 1
                job.ex_a_module = amod or "raw"

    # -W autosplit: map chunk n of m onto a frame range (-L + length;
    # src/split.c:146 maps nav units onto -L/-c the same way)
    if args.autosplit:
        parts = args.autosplit.split(",")
        if len(parts) < 2:
            log.error("tcforge", "-W needs n,m[,navfile]")
            return 1
        job.vob_chunk = int(parts[0])
        job.vob_chunk_max = int(parts[1])
        job.vob_percentage = args.cluster_percentage
        navf = (parts[2] if len(parts) > 2 and parts[2]
                else args.nav_seek)
        total = 0
        if navf and os.path.exists(navf):
            import json
            with open(navf) as f:
                total = int(json.load(f).get("total_pictures", 0))
        if not total:
            total = job.max_frames or 0
        if not total:
            log.error("tcforge", "-W: unknown stream length; provide a "
                      "tcdemux nav file (-W n,m,navfile)")
            return 1
        startc, chunks = job.vob_chunk, 1
        if args.cluster_chunks:
            a, b = args.cluster_chunks.split("-")
            job.vob_chunk_num1, job.vob_chunk_num2 = int(a), int(b)
            startc, chunks = int(a), int(b) - int(a)
        if args.cluster_percentage:
            start = total * job.vob_chunk // 100
            end = total * min(100, job.vob_chunk
                              + job.vob_chunk_max) // 100
        else:
            start = total * startc // job.vob_chunk_max
            end = total * (startc + chunks) // job.vob_chunk_max
        job.vob_offset += start
        job.max_frames = end - start
        log.info("tcforge", "-W chunk %d/%d -> -L %d, %d frames",
                 startc, job.vob_chunk_max, job.vob_offset,
                 job.max_frames)

    if args.psu_chunks:
        ab = args.psu_chunks.split("-")
        args.psu_first = int(ab[0])
        args.psu_last = int(ab[1])
        if not args.psu_mode and not args.no_split:
            args.psu_mode = True

    if args.ranges:
        job.ranges = parse_ranges(args.ranges, job.fps)
    if args.split_time > 0:
        # --split_time: rotation by duration (needs the probed fps)
        job.rotate_frames = max(1, int(round(args.split_time
                                             * (job.fps or 25.0))))
    if args.hard_fps and args.fps:
        job.fps = args.fps             # -f wins over the probe
    job.validate()

    from tcforge_tpu.pipeline.engine import Pipeline

    if args.psu_mode and args.no_split:
        # --no_split: selected units into ONE output file
        # (transcode.c no_split handling in the PSU/chapter modes)
        from tcforge_tpu.io.mpeg import count_psus
        n_units = count_psus(job.video_in_file)
        job.psu_unit = args.psu_first
        job.psu_unit_end = (args.psu_last if args.psu_last >= 0
                            else n_units)
    elif args.psu_mode:
        # PSU core mode (transcode.c:662): one engine run per program
        # stream unit, %d in -o names each unit's output
        if "%d" not in (job.video_out_file or ""):
            log.error("tcforge", "--psu_mode needs %%d in -o")
            return 1
        from tcforge_tpu.io.mpeg import count_psus
        n_units = count_psus(job.video_in_file)
        last = args.psu_last if args.psu_last >= 0 else n_units
        out_tpl = job.video_out_file
        total_frames = 0
        for unit in range(args.psu_first, min(last, n_units)):
            job.psu_unit = unit
            job.video_out_file = out_tpl % unit
            try:
                pipe = Pipeline(job)
                with _sigint_drains(pipe):
                    counters = pipe.run(
                        progress=not args.progress_off
                        and not args.quiet)
            except (IOError, ValueError) as e:
                log.error("tcforge", "PSU %d failed: %s", unit, e)
                return 1
            total_frames += counters.frames_in
            log.info("tcforge", "PSU %d/%d done (%d frames)", unit,
                     n_units, counters.frames_in)
            if pipe.interrupted.is_set():
                break
        return 0 if total_frames > 0 else 1

    try:
        pipe = Pipeline(job)
    except (FileNotFoundError, ValueError, KeyError,
            NotImplementedError) as e:
        log.error("tcforge", "cannot start pipeline: %s", e)
        return 1
    try:
        with _sigint_drains(pipe):
            counters = pipe.run(progress=not args.progress_off
                                and not args.quiet)
    except (IOError, ValueError) as e:
        log.error("tcforge", "pipeline failed: %s", e)
        return 1
    return 0 if counters.frames_in > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
